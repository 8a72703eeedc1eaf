// Gather probe kernels for NVIDIA Hopper (sm_90a): out[b] = table[idx[b]].
//
// Replaces the four TPU kernels of nmcfluid/wost/pallas_probe.py::gather_rows
// (_rows_kernel :38, _lanes_kernel :44, _scalar_kernel :52, _onehot_kernel
// :59). On the TPU they were the candidate ways for a walk kernel to read the
// quad-packed radial table (R = 32512 rows of 4 floats, 520 KB); on the card
// they measure the rate of the walk's per-lane gather in the same four forms.
//
//   gather_rows_k    one 16-byte (float4) load of a row from the table and
//                    one 16-byte store, two rows a thread with both loads
//                    in flight (see its own note below).
//   gather_lanes_k   the table transposed to (4, R) and the output (4, n):
//                    a block stages one row of the transpose in shared
//                    memory and gathers its lanes from there, stores
//                    coalesced along n (see its own note below).
//   gather_scalar_k  the TPU body's loop of scalar slices over one grid
//                    step's 1024 indices, run by a block of 256 threads (see
//                    its own note below).
//   gather_onehot_k  the TPU body's one-hot select over the 128 Z rows, on
//                    the tensor cores as an exact u8 product (see its own
//                    note below).
//
// What bounds them on the card: bytes. Each call reads n int32 indices and
// writes n 16-byte rows; the table stays resident in the 50 MB L2, so HBM
// sees at most its 520 KB once. At n = 524,288 that is 10.5 MB, 3.3 us at
// 3.35 TB/s. Each form adds its own traffic on top (a 32-byte L2 sector
// for each random 16-byte row, a staged row a block, onehot's table
// columns); the notes below say which, and PERF.md how far each gets.
// The launch plans of lanes and onehot (block size, work a thread) are
// Python: wost/pallas_probe.py::lanes_plan, onehot_plan; rows and scalar
// have one fixed launch.
//
// Every kernel applies the probe's repeat offset, i = (idx[b] + offset) % R,
// so that timed repeats read other rows, as the JAX probe's (idx + k) % R.
// Indices must lie in [0, R): the kernels do not check them, the wrapper
// (wost/pallas_probe.py::gather_rows) does.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads per scalar block
constexpr int BLOCK = 1024;      // indices per TPU grid step
constexpr int SCALAR_TRIPS = BLOCK * 4 / NT;   // scalar slices a thread
constexpr int OH_NT = 512;       // threads per onehot block
constexpr int OH_WARPS = OH_NT / 32;
constexpr int OH_J = 256;        // quad columns j0 of the padded table
constexpr int OH_L_MAX = 16384;  // most lanes in a onehot chunk
constexpr int ROWS_G = 2;        // rows a thread of a rows block
constexpr int ROWS_NT = 128;     // threads per rows block
constexpr int NT_MAX = 1024;     // threads of a lanes block, most

// i + off wrapped into [0, R), for i in [0, R) and off = offset % R
__device__ __forceinline__ int wrap(int i, unsigned off, int R) {
  const unsigned j = (unsigned)i + off;
  return (int)(j >= (unsigned)R ? j - (unsigned)R : j);
}

__device__ __forceinline__ int4 wrap4(int4 v, unsigned off, int R) {
  return make_int4(wrap(v.x, off, R), wrap(v.y, off, R), wrap(v.z, off, R),
                   wrap(v.w, off, R));
}

// gather_rows_k replaces _rows_kernel (pallas_probe.py:38-41): jnp.take of
// a 1024-index step's rows from the table in VMEM. On the card the table
// stays in L2 and a row is one 16-byte load, the form the walk kernel will
// read the radius quad in. What bounds it: bytes, and each random row
// costs a whole 32-byte L2 sector for its 16 bytes. The first port gave a
// thread one row, so it had one load in flight, behind its index load and
// a 64-bit modulo for the repeat offset. Here a block of ROWS_NT threads
// takes ROWS_G rows a thread, row c G NT + k NT + t of block c, thread t
// (k < G), so a warp's index loads are 128 contiguous bytes and its stores
// 512; the offset wraps with a compare; both table loads go out through
// the read-only path before the first store. Measured, the loads in flight
// were not what held it: 1 to 16 rows a thread in blocks of 128 to 1024
// threads ran within a few percent of each other at n = 524,288, at the
// rate a streaming copy moves its L2 traffic (indices, a sector a row,
// stores), and 2 rows in blocks of 128 ran best at 65,536 (PERF.md).
__global__ void __launch_bounds__(ROWS_NT)
gather_rows_k(const float4* __restrict__ table, const int* __restrict__ idx,
              float4* __restrict__ out, int n, int R, int offset) {
  const int b0 = blockIdx.x * ROWS_G * ROWS_NT + threadIdx.x;
  const unsigned off = (unsigned)offset % (unsigned)R;
  int i[ROWS_G];
#pragma unroll
  for (int k = 0; k < ROWS_G; ++k) {
    const int b = b0 + k * ROWS_NT;
    i[k] = b < n ? wrap(__ldg(idx + b), off, R) : 0;
  }
  float4 v[ROWS_G];
#pragma unroll
  for (int k = 0; k < ROWS_G; ++k) v[k] = __ldg(table + i[k]);
#pragma unroll
  for (int k = 0; k < ROWS_G; ++k)
    if (b0 + k * ROWS_NT < n) out[b0 + k * ROWS_NT] = v[k];
}

// gather_lanes_k reads the transpose padded to (4, lanes_pitch(R)), so
// that each of its rows starts on 16 bytes;
// wost/pallas_probe.py::lanes_pitch mirrors it.
__host__ __device__ constexpr int lanes_pitch(int R) { return (R + 3) & ~3; }

// gather_lanes_k replaces _lanes_kernel (pallas_probe.py:44-49): the TPU
// body held the whole (4, R) transpose in VMEM and gathered along its
// lanes, out (4, n). The first port read table_t[q][i] from L2 for each q
// of a lane: four 4-byte reads 127 KB apart, each its own 32-byte sector
// (8 times the bytes the function needs: 67 MB of sectors at n =
// 524,288), behind one dependent index load. One row of the transpose
// fits a block's shared memory (130,048 bytes for the radial table), so a
// block takes the VMEM's part for one q:
// * block x owns row q = x % 4 and the chunk x / 4 of G nt lanes;
// * each thread starts 16-byte cp.async copies of its pieces of the row
//   (pieces t + u nt) into shared memory, then loads its lanes' indices 16
//   bytes at a time (lanes base + 4 (j nt + t) .. + 3, j < G / 4) and
//   wraps the offset while the row arrives; it waits for its copies, and
//   one block barrier makes the whole row visible;
// * each thread reads its lanes' values from shared memory and stores each
//   group of four as a float4, so a warp's stores to row q of out are 512
//   contiguous bytes.
// L2 then serves each block's row once: ctas x 4 Rp bytes (16.6 MB at n =
// 524,288 on 128 blocks), against 67 MB of sectors. What bounds it:
// bytes, of the staged rows (a fixed cost a block, and at 130 KB of shared
// memory one block fits an SM) and of indices and output. The row comes in
// by cp.async, beside the index loads and through no registers; staged
// through registers (16-byte loads, then shared stores) or by one bulk
// async copy on an mbarrier (cp.async.bulk) it came slower, and clusters
// sharing one bulk copy by multicast slower still; reading the four rows
// from L2 with all of a thread's loads in flight, and no staging, ran 2.4
// times as long (PERF.md). lanes_plan (wost/pallas_probe.py) picks G and
// nt; the wrapper refuses a table whose row does not fit shared memory
// (R > LANES_R_MAX there).
template <int G>
__global__ void __launch_bounds__(NT_MAX, 1)
gather_lanes_k(const float* __restrict__ table_t,
               const int* __restrict__ idx, float* __restrict__ out_t,
               int n, int R, int offset) {
  extern __shared__ float4 s_row4[];
  const float* s_row = reinterpret_cast<const float*>(s_row4);
  const int nt = blockDim.x, t = threadIdx.x;
  const int q = blockIdx.x & 3;
  const int base = (blockIdx.x >> 2) * G * nt;
  const int nv = lanes_pitch(R) / 4;           // 16-byte pieces of the row
  const float4* row = reinterpret_cast<const float4*>(
      table_t + (size_t)q * lanes_pitch(R));
  const unsigned off = (unsigned)offset % (unsigned)R;
  const unsigned s_base = (unsigned)__cvta_generic_to_shared(s_row4);
  for (int i = t; i < nv; i += nt)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 ::"r"(s_base + 16 * i), "l"(row + i) : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
  int4 v[G / 4];
#pragma unroll
  for (int j = 0; j < G / 4; ++j) {
    const int b = base + 4 * (j * nt + t);
    v[j] = b < n ? wrap4(__ldg(reinterpret_cast<const int4*>(idx + b)), off,
                         R)
                 : make_int4(0, 0, 0, 0);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  float* o = out_t + (size_t)q * n;
#pragma unroll
  for (int j = 0; j < G / 4; ++j) {
    const int b = base + 4 * (j * nt + t);
    if (b < n)
      *reinterpret_cast<float4*>(o + b) = make_float4(
          s_row[v[j].x], s_row[v[j].y], s_row[v[j].z], s_row[v[j].w]);
  }
}

// gather_scalar_k replaces _scalar_kernel (pallas_probe.py:52-56): a
// fori_loop of scalar dynamic slices over the grid step's 1024 indices, read
// from SMEM. On the TPU the grid ran in order on one core; the card runs
// the grid steps as parallel blocks, and one thread per step (the first
// port) left 512 threads to a 132-SM card and made each a chain of 1024
// dependent loads. Here one block of 256 threads takes a grid step: it
// loads the 1024 indices into shared memory with 16-byte loads (the TPU's
// idx_ref) and applies the offset there; then each thread moves 16 scalar
// slices, element t % 4 of rows trip * 64 + t / 4, so a warp reads 8 rows
// as 16-byte segments of 4 scalar loads and writes 128 contiguous bytes.
// The trips are unrolled and every load is issued before the first store:
// 16 loads in flight a thread instead of one chain. It stays scalar (4-byte
// loads and stores); a float4 copy of each row would be gather_rows_k.
// Bound: bytes, as every form.
__global__ void __launch_bounds__(NT)
gather_scalar_k(const float* __restrict__ table, const int* __restrict__ idx,
                float* __restrict__ out, int n, int R, int offset) {
  __shared__ __align__(16) int s_idx[BLOCK];
  const int base = blockIdx.x * BLOCK;
  const int t = threadIdx.x;
  const unsigned off = (unsigned)offset % (unsigned)R;
  int4 v = reinterpret_cast<const int4*>(idx + base)[t];
  v.x = wrap(v.x, off, R);
  v.y = wrap(v.y, off, R);
  v.z = wrap(v.z, off, R);
  v.w = wrap(v.w, off, R);
  reinterpret_cast<int4*>(s_idx)[t] = v;
  __syncthreads();
  const int q = t & 3, r0 = t >> 2;
  float val[SCALAR_TRIPS];
#pragma unroll
  for (int k = 0; k < SCALAR_TRIPS; ++k)
    val[k] = __ldg(table + (long long)s_idx[k * (NT / 4) + r0] * 4 + q);
#pragma unroll
  for (int k = 0; k < SCALAR_TRIPS; ++k)
    out[(long long)(base + k * (NT / 4) + r0) * 4 + q] = val[k];
}

// gather_onehot_k replaces _onehot_kernel (pallas_probe.py:59-76): a one-hot
// (1024, 128) x (128, 1024) product on the MXU at HIGHEST precision, then
// masked lane sums that pick the quad 4 j0 + q of Z row i0 = i / 256. The
// card does the product on its tensor cores, exactly, and picks the quad by
// grouping lanes instead of masking. Only lanes with the same quad column
// j0 = i % 256 share a B operand, so lanes are grouped by j0:
//
// * The grid is chunks x ranges: a block takes a chunk of Lc lanes and a
//   range of J = 256 / ranges quad columns, and keeps the chunk's lanes
//   whose j0 it owns (wost/pallas_probe.py::onehot_plan picks Lc and
//   ranges). It sorts them by j0 in shared memory: a J-bin histogram whose
//   shared atomics give each lane its rank in its column (in any order: a
//   lane's result does not depend on its place), an exclusive scan, and
//   each (lane, i0) key written to its column's start plus its rank.
// * Warp w owns columns j_lo + w + 16 k. A column's B operand is its 128 Z
//   rows x 16 bytes, as the u8 B fragments of mma.sync.m16n8k32: 16 words
//   a lane, 2 KB a warp. The wrapper lays the table out in that fragment
//   order once (_kernel_table), so a column's B is 2 KB contiguous; a warp
//   reads it with coalesced 16-byte loads through L1, once for each pair
//   of tiles.
// * Each 16-lane tile of a column (the last one masked) builds A, the
//   one-hot of its lanes' i0 over the 128 Z rows, in registers, and runs 8
//   mma.sync (4 k-steps of 32 Z rows x 2 n8 halves of the 16 bytes), u8 x
//   u8 -> s32. Each sum has one nonzero term, the byte itself, so the
//   product is exact for every bit pattern: -0.0, subnormals, inf, nan.
//   A warp takes two tiles at a time, for independent mma chains.
// * The select: B's bytes are ordered so that the s32 fragment gives lane
//   (g, t) bytes 4t .. 4t + 3 of its rows g and g + 8, i.e. float t of
//   each. Two byte permutes make the word, and the 4 lanes of a row store
//   its 16 bytes at the lane's own position in `out` (the counterpart of
//   the TPU's masked lane sum).
//
// What bounds it: the function is bound by bytes (3.3 us at n = 524,288).
// The form adds the sort and the products, and those, not bytes, bound it
// (PERF.md). A first design gave every block all 256 columns (few,
// large blocks, each streaming the whole 512 KB table from L2 and staging
// its rows for coalesced stores): 0.028 ms at n = 524,288, slower than
// table.T[:, idx].T. Splitting the columns into ranges cuts a block's
// table reads to 512 KB / ranges, at the price of reading the chunk's
// indices once a range. Clock stamps of each phase
// (wost/gather_phases.py) then put the tile phase at 60% of a block's
// cycles at n = 524,288, where storing no row saves 39% of it and running
// a quarter of the mma 11%: the scattered 16-byte row stores and the
// instructions that build A and pick the bytes bound it, not the tensor
// cores or bytes; the sort's two passes over the chunk take most of the
// rest. Keeping B in 64 registers a lane (all of a warp's columns, loaded
// before the sort) ran no faster than reading it through L1, which lets two
// blocks share an SM (62 registers a thread). A cluster of one block a
// range sharing the chunk's sort (each ranking a quarter of the lanes and
// storing the keys into their column owner's shared memory) was exact but
// slower: the stores to distributed shared memory and the cluster barriers
// cost more than the rescans they saved. Sharing one read of the table by
// TMA multicast was not tried.
__host__ __device__ constexpr unsigned onehot_smem(int Lc, int J) {
  // rows and keys, Lc x 4 bytes each; J + 1 bucket starts and J counts;
  // wost/pallas_probe.py::onehot_smem mirrors it
  return (unsigned)Lc * 8u + (2u * J + 1u) * 4u;
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two 16-lane tiles, sorted positions [p, p + 32) clipped to `end`, of the
// column whose B fragments for this lane start at fb: per k-step s, fb[32 s]
// = {(h 0, k rows 0-15), (h 0, 16-31), (h 1, 0-15), (h 1, 16-31)}, read
// through L1 and shared by both tiles. Row r = 0 .. 3 of this lane is
// position p + g + 8 r: rows g and g + 8 of tile r / 2. A row's one-hot
// byte lies in A register (s, hi) with 2 s + hi = i0 / 16, of lane t = (i0
// / 4) % 4, byte i0 % 4.
__device__ __forceinline__ void onehot_pair(const uint4* __restrict__ fb,
                                            const unsigned* s_key,
                                            unsigned* out, int p, int end,
                                            int g, int t) {
  unsigned key[4], q[4], w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // a masked row gets i0 = 255: slot 15 matches no A register
    key[r] = p + g + 8 * r < end ? s_key[p + g + 8 * r] : 0xFFu;
    q[r] = (key[r] & 0xFFu) >> 4;
    w[r] = ((key[r] >> 2) & 3u) == (unsigned)t ? 1u << ((key[r] & 3u) * 8u)
                                               : 0u;
  }
  int acc[2][2][4] = {};                 // [tile][n8 half h][fragment]
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint4 b = __ldg(fb + 32 * s);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const unsigned a[4] = {
          q[2 * u] == 2u * s ? w[2 * u] : 0u,
          q[2 * u + 1] == 2u * s ? w[2 * u + 1] : 0u,
          q[2 * u] == 2u * s + 1u ? w[2 * u] : 0u,
          q[2 * u + 1] == 2u * s + 1u ? w[2 * u + 1] : 0u};
      mma_u8(acc[u][0], a, b.x, b.y);
      mma_u8(acc[u][1], a, b.z, b.w);
    }
  }
  // acc[u][h] = D(g, 2t), D(g, 2t + 1), D(g + 8, 2t), D(g + 8, 2t + 1) of
  // n8 half h = bytes 4t + 2h, 4t + 2h + 1 of rows g and g + 8: float t
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int (&d0)[4] = acc[r / 2][0], (&d1)[4] = acc[r / 2][1];
    const int e = 2 * (r % 2);
    if (p + g + 8 * r < end)
      out[(key[r] >> 8) * 4 + t] =
          __byte_perm(__byte_perm(d0[e], d0[e + 1], 0x40),
                      __byte_perm(d1[e], d1[e + 1], 0x40), 0x5410);
  }
}

// NB: columns a warp owns; J = 16 NB columns a block, 256 / J ranges
template <int NB>
__global__ void __launch_bounds__(OH_NT, 2)
gather_onehot_k(const uint4* __restrict__ frag, const int* __restrict__ idx,
                unsigned* __restrict__ out, int n, int R, int offset,
                int Lc) {
  constexpr int J = OH_WARPS * NB;
  constexpr int NR = OH_J / J;
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_row = reinterpret_cast<int*>(smem);
  unsigned* s_key = reinterpret_cast<unsigned*>(smem + (size_t)Lc * 4);
  int* s_start = reinterpret_cast<int*>(smem + (size_t)Lc * 8);
  int* s_cnt = s_start + J + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j_lo = (blockIdx.x % NR) * J;
  const int base = (blockIdx.x / NR) * Lc;
  const int nl = min(Lc, n - base);      // a multiple of 1024
  const unsigned off = (unsigned)offset % (unsigned)R;

  for (int j = tid; j < J; j += OH_NT) s_cnt[j] = 0;
  __syncthreads();
  // 1. each lane's row i (offset applied) and, for a lane of an owned
  // column, its rank in the column from the histogram's atomic: s_row[b] =
  // rank << 15 | i (i < 32512), or -1 for a lane the block does not own
  const int4* idx4 = reinterpret_cast<const int4*>(idx + base);
  for (int v0 = 0; v0 < nl / 4; v0 += 4 * OH_NT) {
    int4 q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int v = v0 + tid + u * OH_NT;
      if (v < nl / 4) q[u] = idx4[v];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int v = v0 + tid + u * OH_NT;
      if (v < nl / 4) {
        const int r[4] = {wrap(q[u].x, off, R), wrap(q[u].y, off, R),
                          wrap(q[u].z, off, R), wrap(q[u].w, off, R)};
        int p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned j = (unsigned)((r[e] & 0xFF) - j_lo);
          p[e] = j < (unsigned)J ? (atomicAdd(&s_cnt[j], 1) << 15) | r[e]
                                 : -1;
        }
        reinterpret_cast<int4*>(s_row)[v] = make_int4(p[0], p[1], p[2], p[3]);
      }
    }
  }
  __syncthreads();
  // 2. exclusive scan of the J counts by warp 0
  if (warp == 0) {
    constexpr int PER = (J + 31) / 32;
    int c[PER], sum = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = lane * PER + k;
      c[k] = j < J ? s_cnt[j] : 0;
      sum += c[k];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int j = lane * PER + k;
      if (j < J) s_start[j] = run;
      run += c[k];
    }
    if (lane == 31) s_start[J] = run;
  }
  __syncthreads();
  // 3. the owned lanes' keys (lane << 8 | i0) to their column's start plus
  // their rank: no atomics, four lanes a thread in flight
  for (int b0 = tid; b0 < nl; b0 += 4 * OH_NT) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int bl = b0 + u * OH_NT;
      v[u] = bl < nl ? s_row[bl] : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (v[u] >= 0) {
        const int i = v[u] & 0x7FFF;
        s_key[s_start[(i & 0xFF) - j_lo] + (v[u] >> 15)] =
            ((unsigned)(b0 + u * OH_NT) << 8) | (unsigned)(i >> 8);
      }
    }
  }
  __syncthreads();
  // 4. the products, two tiles at a time, rows stored where their lanes are
  unsigned* o = out + (size_t)base * 4;
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < NB; ++k) {
    const int j = warp + OH_WARPS * k;
    const uint4* fb = frag + (j_lo + j) * 128 + lane;
    const int end = s_start[j + 1];
    for (int p = s_start[j]; p < end; p += 32)
      onehot_pair(fb, s_key, o, p, end, g, t);
  }
}

template <int NB>
int onehot_run(const float* table, const int* idx, float* out, int n, int R,
               int reps, int Lc, cudaStream_t stream) {
  constexpr int NR = OH_J / (OH_WARPS * NB);
  const unsigned smem = onehot_smem(Lc, OH_WARPS * NB);
  cudaError_t err = cudaFuncSetAttribute(
      gather_onehot_k<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + Lc - 1) / Lc * NR;
  for (int off = 0; off < reps; ++off) {
    gather_onehot_k<NB><<<grid, OH_NT, smem, stream>>>(
        reinterpret_cast<const uint4*>(table), idx,
        reinterpret_cast<unsigned*>(out), n, R, off, Lc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// `reps` launches of `kernel` on `grid` blocks of `nt` threads, the r-th
// with offset r; the first CUDA error, or 0
template <typename In, typename Out>
int run_reps(void (*kernel)(const In*, const int*, Out*, int, int, int),
             int grid, int nt, unsigned smem, const float* table,
             const int* idx, float* out, int n, int R, int reps,
             cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  for (int off = 0; off < reps; ++off) {
    kernel<<<grid, nt, smem, stream>>>(reinterpret_cast<const In*>(table),
                                       idx, reinterpret_cast<Out*>(out), n,
                                       R, off);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int lanes_run(const float* table, const int* idx, float* out, int n, int R,
              int reps, int G, int nt, cudaStream_t stream) {
  if (nt < 32 || nt > NT_MAX || nt % 32) return -1;
  const int chunks = (n + G * nt - 1) / (G * nt);
  const unsigned smem = 4u * (unsigned)lanes_pitch(R);
  switch (G) {
#define LANES_CASE(g)                                                      \
    case g:                                                                \
      return run_reps(gather_lanes_k<g>, 4 * chunks, nt, smem, table, idx, \
                      out, n, R, reps, stream);
    LANES_CASE(4) LANES_CASE(8) LANES_CASE(16) LANES_CASE(32)
#undef LANES_CASE
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Launches `reps` gathers of one variant on `stream`, the r-th with offset
// r (r = 0 .. reps - 1), all writing `out`. variant: 0 rows, 1 lanes, 2
// scalar, 3 onehot. `table` is the (R, 4) table for rows and scalar, its
// (4, R) transpose padded to (4, lanes_pitch(R)) for lanes, and for onehot
// the padded (128, 1024) table in B-fragment order, (256, 4, 32, 4) words
// (see gather_onehot_k); `out` is (n, 4), or (4, n) for lanes. n is a
// multiple of 1024, and `idx` 16-byte aligned for lanes, scalar and
// onehot; for lanes, 4 lanes_pitch(R) bytes fit a block's shared memory.
// plan_a and plan_b are the variant's launch plan: for lanes, lanes a
// thread (4, 8, 16 or 32) and threads a block (a multiple of 32 up to
// 1024); for onehot, the chunk's lanes (a multiple of 1024, at most
// 16,384) and its column ranges (4, 8 or 16); rows and scalar ignore
// them. Returns the first CUDA error, or -1 for an unknown variant or
// plan.
int gather_run(int variant, const float* table, const int* idx, float* out,
               int n, int R, int reps, int plan_a, int plan_b,
               cudaStream_t stream) {
  if (variant == 3) {
    if (plan_a < BLOCK || plan_a > OH_L_MAX || plan_a % BLOCK) return -1;
    switch (plan_b) {
      case 4:
        return onehot_run<4>(table, idx, out, n, R, reps, plan_a, stream);
      case 8:
        return onehot_run<2>(table, idx, out, n, R, reps, plan_a, stream);
      case 16:
        return onehot_run<1>(table, idx, out, n, R, reps, plan_a, stream);
      default: return -1;
    }
  }
  switch (variant) {
    case 0:
      return run_reps(gather_rows_k, (n + ROWS_G * ROWS_NT - 1) /
                      (ROWS_G * ROWS_NT), ROWS_NT, 0, table, idx, out, n, R,
                      reps, stream);
    case 1:
      return lanes_run(table, idx, out, n, R, reps, plan_a, plan_b, stream);
    case 2:
      return run_reps(gather_scalar_k, n / BLOCK, NT, 0, table, idx, out, n,
                      R, reps, stream);
    default: return -1;
  }
}

}  // extern "C"

// Fused Adam phase fit for a SIREN, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nmcfluid/sim/fitkernel.py::_fused_call/_kernel:
// n_iters Adam steps on a SIREN (sin(30 z) hidden layers, linear head)
// over a pool of K fixed minibatches, cycling batch i % K, with the loss
//     sum_p w_p |A_p raw(x_p) + c_p - tgt_p|^2
// (1/norm is folded into w by the wrapper), returning the last loss.
//
// Design: ONE persistent cooperative launch per fit (the TPU kernel is one
// pallas_call per fit). All G blocks are resident at once (G <= SMs,
// cudaLaunchCooperativeKernel refuses anything else) and loop over the
// n_iters iterations together. Block b owns
//   - the point tiles [b * tiles_per_block, ...) of every batch (T = 32
//     points a tile; Taylor-Green: one tile a block, 128 blocks), taken
//     pass_tiles (1 or 2) at a time through every layer, and
//   - the parameter slice [b * chunk, ...) with its Adam moments m and v,
//     which stay in shared memory for the whole fit (what VMEM did on the
//     TPU, spread over the SMs) unless the slice is too large (below).
// One iteration:
//   (a) read the current parameters (L2-resident) into shared memory;
//   (b) forward and backward over the block's tiles, a pass at a time;
//       the block sums its tiles' gradients in tile order in its own
//       partial-gradient row (column sums over points per 32-point tile,
//       so that a pass of two tiles adds the same floats in the same
//       order as two passes of one);
//   (c) the row and the block's loss go to global memory;
//   (d) grid barrier;
//   (e) each block sums its slice over the n_work rows in a fixed order,
//       takes the optax-style Adam step on it (m, v on chip, lr[i], the
//       1 - b^t bias corrections in double as before) and writes the
//       slice's parameters back; on the last iteration block 0 sums the
//       loss in block order;
//   (f) grid barrier.
// No float atomics anywhere: two runs give bit-identical results.
//
// Layer products. Forward z = h W and input gradient g_z W^T take points
// as rows and units as columns; the weight gradient h^T g_z takes fan-in
// as rows, units as columns and sums over the pass's points. Each thread
// sums a register micro-tile in plain f32 FMA, in order over k, so that
// each shared load is a float4 (or float2) row segment: where a pass holds
// 4,096 outputs (a 32-point tile at H padded to 128, or two tiles at 64:
// "wide") 4 points x 4 units (prod_wide), else 2 points x 2 * NPW adjacent
// units (H padded to 32 * NPW; prod_points); 2 * NPW x 2 * NPW adjacent
// (fan-in, unit) pairs for the weight gradient. Shared-load instructions,
// not FMAs, bound the products: fewer and wider loads per FMA is what the
// micro-tiles buy. (A 3xTF32 mma.sync route was measured
// and dropped: slower here, and outside the kernel-vs-twin tolerance at
// B = 16384; PERF.md.) Operands live in shared memory in an XOR-swizzled
// layout (sw() below) that is conflict-free for the row-wise and the
// transposed accesses. The first layer (fan-in 2 or 3), the head (fan-out
// 2 or 3) and the bias sums run on the CUDA cores too. sin and cos use
// the accurate sincosf (no --use_fast_math: __sinf is wrong at |30 z| ~
// 300).
//
// sin and cos of every layer are kept in shared memory for the backward
// pass when they fit ("store"). Otherwise ("recompute") each layer's z
// goes to a per-block stash in global memory (L2) and the backward pass
// recomputes sin and cos from it, in five shared buffers whatever the
// depth: two ping-pong sin buffers and a ring of three for cos, then g_z.
// Hidden weights, each with its bias, are staged per layer with cp.async
// into a ring of one or two buffers (two: the next layer's load overlaps
// this layer's products, and the last two layers of the forward pass
// serve the backward pass without a reload; one: the next layer's load
// is issued after this layer's epilogue, which measured faster than
// issuing it behind a barrier after the product). A pass's pool data (x,
// A, c, target, w) is fetched with cp.async while the block finishes the
// pass before it, or, for the first pass of an iteration, while it waits
// at the barriers. The Adam step takes its slice in passes of at most
// pass_cols columns; m and v stay in shared memory unless they do not fit
// beside the rest, and then live in global memory.
//
// The launch plan (G, tiles and parameter range per block, tiles a pass,
// buffers, shared-memory bytes) is computed by
// sim/fitkernel.py::fit_plan and passed in as an int64 array; this file
// only checks it.
//
// Parameter layout (one flat f32 buffer, the JAX package's (fan_in, fan_out)
// row-major weights; the wrapper pads it to a multiple of 4 floats):
//   w_first (D_in, H) | b_first (H) | Lh x [w_hid (H, H) | b_hid (H)] |
//   w_out (H, D_out) | b_out (D_out)
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads per block: 8 warps, 2 (M) x 4 (N)
constexpr int T = 32;        // points per tile, the column sums' unit
constexpr float OMEGA = 30.0f;
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float ADAM_EPS = 1e-8f;

// Phases timed by thread 0 of block 0 when Args::phases is set (cycles,
// summed over the fit in Args::phases): staging and first layer, hidden
// forward products,
// their sin/cos epilogue, head, hidden weight gradients, hidden input
// gradients with their epilogue, first-layer backward, wait at barrier
// (d), Adam, wait at barrier (f); then the whole loop in cycles and in
// nanoseconds (sim/fitkernel.py::PHASES).
enum Phase { PH_FIRST, PH_FWD_PROD, PH_FWD_EPI, PH_HEAD, PH_BWD_WGRAD,
             PH_BWD_IGRAD, PH_BWD_FIRST, PH_WAIT_D, PH_ADAM, PH_WAIT_F,
             N_PHASES };

// Field order of the plan array (sim/fitkernel.py::_PLAN_FIELDS).
enum PlanField {
  F_D_IN, F_D_OUT, F_H, F_LH, F_B, F_K, F_N_ITERS, F_HP, F_N_PARAMS,
  F_N_TILES, F_TILES_PER_BLOCK, F_PASS_TILES, F_N_WORK, F_G, F_CHUNK,
  F_PASS_COLS, F_N_WBUF, F_RECOMPUTE, F_MOMENTS_GLOBAL, F_LD_PART,
  F_ROW_GROUPS, F_SMEM_BYTES, N_PLAN_FIELDS
};

struct Plan {
  int D_in, D_out, H, Lh, B, K, n_iters, Hp;
  long long n_params;
  int n_tiles, tiles_per_block, pass_tiles, n_work, G, chunk, pass_cols, n_wbuf,
      recompute, moments_global;
  long long ld_part;
  int row_groups;
  long long smem_bytes;
};

struct Args {
  float* params;
  const float *x, *A, *c, *tgt, *w, *lr;
  float *part, *loss_part, *loss_out;
  unsigned* barrier;
  float* zstash;       // recompute: (n_work, Lh + 1, T, Hp), else null
                       // (a recompute plan takes one tile a pass)
  float* moments;      // moments_global: (G, 2, chunk) zeroed, else null
  long long* phases;   // null, or N_PHASES + 2 zeroed int64 (Phase)
  Plan p;
};

// Shared-memory layout in floats; every region is a multiple of 4 floats
// so that each starts 16-byte aligned.
struct Smem {
  long long act, wbuf, bh, fs, hs, X, PA, PC, PT, PW, GR, red, m, rsum,
      total;
};

__host__ __device__ inline Smem smem_layout(const Plan& p) {
  Smem s;
  long long o = 0;
  const long long P = (long long)T * p.pass_tiles;  // points a pass
  const long long PH = P * p.Hp;
  const int nbuf = p.Lh > 0 ? p.n_wbuf : 0;
  s.act = o;  o += (p.recompute ? 5 : 2 * (p.Lh + 1)) * PH;
  s.wbuf = o; o += nbuf * (long long)p.Hp * p.Hp;
  s.bh = o;   o += nbuf * (long long)p.Hp;  // each buffer's bias
  s.fs = o;   o += 4LL * p.Hp;              // w_first | b_first, flat
  s.hs = o;   o += 4LL * p.Hp + 4;          // w_out | b_out, flat
  s.X = o;    o += 4 * P;                   // the pass's pool data:
  s.PA = o;   o += 9 * P;                   //   x (P, 4), A (P, Do, Do),
  s.PC = o;   o += 3 * P;                   //   c, target (P, Do), w (P)
  s.PT = o;   o += 3 * P;
  s.PW = o;   o += P;
  s.GR = o;   o += 4 * P;                   // (P, 4) gradient wrt raw
  s.red = o;  o += 32;                      // per-warp loss sums a tile
  s.m = o;    o += p.moments_global ? 0 : 2LL * p.chunk;  // m | v
  s.rsum = o; o += (long long)p.row_groups * p.pass_cols;  // group sums
  s.total = o;
  return s;
}

// Swizzled offset of element (r, c) of a row-major matrix with ld % 32 ==
// 0. The accesses read (r0 + g, c0 + t) or (r0 + t, c0 + g) over the warp
// (g = lane / 4 < 8, t = lane % 4, r0 and c0 multiples of 4), scalars or
// float2 / float4 along c: XOR-ing c with ((r & 3) << 3) | (r & 4) puts
// each on distinct banks. Groups of 4 along c stay contiguous. The wide
// products' float4 loads read, in each quarter-warp, one row's eight
// quads of a 32-column block, or one quad of eight consecutive rows (r0 a
// multiple of 8), which the XOR also puts on distinct banks.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
__device__ __forceinline__ int sw(int r, int c, int ld) {
  return r * ld + (c ^ swz(r));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes from L2 (parameters: written by other blocks, so not via L1)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
// 4 bytes of read-only pool data
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// all but the most recently committed group
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// All G blocks wait here until every block has arrived. `count` starts at
// 0 for the launch; `target` is this block's running arrival total. A
// wait of more than 20 s (a fit's barriers take microseconds) traps, so a
// fault shows as a launch failure instead of a hung card.
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned G,
                                             unsigned& target) {
  target += G;
  __syncthreads();
  if (threadIdx.x == 0) {
    // release: the block's writes (ordered before by __syncthreads) become
    // visible before the arrival; the acquire loads below pair with it
    asm volatile("fence.acq_rel.gpu;\n"
                 "red.relaxed.gpu.global.add.u32 [%0], %1;\n" ::"l"(count),
                 "r"(1u)
                 : "memory");
    const unsigned long long t0 = global_ns();
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(count)
                   : "memory");
      if ((int)(seen - target) >= 0) break;
      if (global_ns() - t0 > 20000000000ull) __trap();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ long long off_hid(const Plan& p, int l) {
  return (long long)p.D_in * p.H + p.H + (long long)l * (p.H * p.H + p.H);
}
__device__ __forceinline__ long long off_out(const Plan& p) {
  return off_hid(p, p.Lh);
}

// n floats of the parameters into shared memory as they lie: 16-byte
// cp.async where H % 4 == 0 (every segment is then 16-byte aligned and
// the wrapper's padding covers rounding n up to 4), else plain L2 loads.
__device__ void stage_flat(float* dst, const float* src, int n, int H) {
  if ((H & 3) == 0) {
    for (int e = 4 * threadIdx.x; e < n; e += 4 * NT)
      cp_async16(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += NT) dst[e] = __ldcg(src + e);
  }
}

// Hidden weight h (H, H) into a swizzled (Hp, Hp) buffer, its bias into
// the buffer's bias row; the padding was zeroed once and is never
// written. Commits one cp.async group.
template <int Hp>
__device__ void stage_hidden(float* dst, float* bh, const float* params,
                             const Plan& p, int h) {
  const float* src = params + off_hid(p, h);
  const int H = p.H;
  if ((H & 3) == 0) {
    for (int e = threadIdx.x; e < Hp * Hp / 4; e += NT) {
      const int r = e / (Hp / 4), c = (e % (Hp / 4)) * 4;
      if (r < H && c < H)
        cp_async16(dst + sw(r, c, Hp), src + (long long)r * H + c);
    }
  } else {
    for (int e = threadIdx.x; e < H * H; e += NT) {
      const int r = e / H, c = e - r * H;
      dst[sw(r, c, Hp)] = __ldcg(src + e);
    }
  }
  stage_flat(bh, src + (long long)H * H, H, H);
  cp_async_commit();
}

// Which activation buffers hold what. store: S(l) sin, C(l) cos, then g_z,
// all in shared memory. recompute: z of layer l in the global stash Z(l);
// in shared memory S(l) is one of two ping-pong sin buffers and C(l) one
// of a ring of three that holds z (copied back from the stash), then cos,
// then g_z. A backward stage h reads C(h + 1), writes C(h) and prepares
// C(h - 1): three distinct buffers.
struct Act {
  float* base;
  float* zs;
  int PH, Lh, recompute;   // PH: a layer's floats over a pass
  __device__ float* S(int l) const {
    return base + (long long)(recompute ? 3 + (l & 1) : l) * PH;
  }
  __device__ float* C(int l) const {
    return base + (long long)(recompute ? l % 3 : Lh + 1 + l) * PH;
  }
  __device__ float* Z(int l) const { return zs + (long long)l * PH; }
};

// s, c = sin(30 z), cos(30 z): the forward epilogues' one call site
__device__ __forceinline__ void sincos30(float z, float& s, float& c) {
  sincosf(OMEGA * z, &s, &c);
}

// Forward epilogue of one unit: S <- sin(30 z), and C <- cos(30 z) (store)
// or Z <- z (recompute).
__device__ __forceinline__ void put_act(const Act& a, int l, int idx,
                                        float z) {
  float s, c;
  sincos30(z, s, c);
  a.S(l)[idx] = s;
  if (a.recompute) __stcg(a.Z(l) + idx, z);
  else a.C(l)[idx] = c;
}

// Recompute mode, backward: layer l's z (copied back into C(l) by
// unstash) becomes cos in C(l), its sin goes to S(l), ready for the next
// (lower) backward stage.
__device__ __forceinline__ void prepare(const Act& a, int l, int idx) {
  float s, c;
  sincosf(OMEGA * a.C(l)[idx], &s, &c);
  a.S(l)[idx] = s;
  a.C(l)[idx] = c;
}

// Recompute mode: cp.async of layer l's z from the stash into C(l), in the
// same swizzled layout, 16 bytes a copy (PH is a multiple of 4; the stash
// was written through L2). Commits one cp.async group.
__device__ __forceinline__ void unstash(const Act& a, int l) {
  for (int e = 4 * threadIdx.x; e < a.PH; e += 4 * NT)
    cp_async16(a.C(l) + e, a.Z(l) + e);
  cp_async_commit();
}

// Column of output acc[j][e] of the points-major products (rows are
// (warp & 1) * 16 + g + 8 (e >> 1) throughout): 2 * NPW adjacent units a
// thread for the forward product, which then loads them as one row
// segment; for the input gradient (WT) pairs of units 8 apart, which keep
// its loads of 2 * NPW weight rows on distinct banks.
template <int NPW, bool WT>
__device__ __forceinline__ int out_col(int warp, int t, int j, int e) {
  const int nb = (warp >> 1) * NPW * 8;
  return WT ? nb + 8 * j + 2 * t + (e & 1)
            : nb + 2 * NPW * t + 2 * j + (e & 1);
}

// v = row[c0 .. c0 + C) of a swizzled row (s = swz of the row), as float4
// loads where C % 4 == 0 (c0 a multiple of 4), else float2 (c0 even).
template <int C>
__device__ __forceinline__ void load_row(float (&v)[C], const float* row,
                                         int c0, int s) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int u = 0; u < C; u += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + ((c0 + u) ^ s));
      v[u] = q.x; v[u + 1] = q.y; v[u + 2] = q.z; v[u + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < C; u += 2) {
      const float2 q = *reinterpret_cast<const float2*>(row + ((c0 + u) ^ s));
      v[u] = q.x; v[u + 1] = q.y;
    }
  }
}

// acc (32 x Hp over the block) = A (32 x Hp, swizzled) . B, where
// B(k, n) = W[k][n] (forward, WT = false) or W[n][k] (input gradient,
// WT = true), W swizzled (Hp x Hp). Warp w: rows (w & 1) * 16, columns
// (w >> 1) * NPW * 8 + [0, NPW * 8); acc[j][e] is row g + 8 (e >> 1) of
// that and column out_col(j, e).
template <int NPW, bool WT>
__device__ __forceinline__ void prod_points(const float* A, const float* W,
                                            float (&acc)[NPW][4]) {
  constexpr int Hp = 32 * NPW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 16;
#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int r0 = m0 + g, r1 = r0 + 8;
  const float* A0 = A + r0 * Hp;
  const float* A1 = A + r1 * Hp;
  const int s0 = swz(r0), s1 = swz(r1);
  const int cb = out_col<NPW, false>(warp, t, 0, 0);
#pragma unroll 2
  for (int k4 = 0; k4 < Hp; k4 += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(A0 + (k4 ^ s0));
    const float4 a1 = *reinterpret_cast<const float4*>(A1 + (k4 ^ s1));
    const float x0[4] = {a0.x, a0.y, a0.z, a0.w};
    const float x1[4] = {a1.x, a1.y, a1.z, a1.w};
    if constexpr (!WT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[2 * NPW];
        load_row<2 * NPW>(w, W + (k4 + kk) * Hp, cb, swz(k4 + kk));
#pragma unroll
        for (int j = 0; j < NPW; ++j) {
          acc[j][0] = fmaf(x0[kk], w[2 * j], acc[j][0]);
          acc[j][1] = fmaf(x0[kk], w[2 * j + 1], acc[j][1]);
          acc[j][2] = fmaf(x1[kk], w[2 * j], acc[j][2]);
          acc[j][3] = fmaf(x1[kk], w[2 * j + 1], acc[j][3]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 2 * NPW; ++q) {
        const int j = q >> 1, e = q & 1;
        const int c = out_col<NPW, true>(warp, t, j, e);
        const float4 u = *reinterpret_cast<const float4*>(
            W + c * Hp + (k4 ^ swz(c)));
        const float y[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[j][e] = fmaf(x0[kk], y[kk], acc[j][e]);
          acc[j][2 + e] = fmaf(x1[kk], y[kk], acc[j][2 + e]);
        }
      }
    }
  }
}

// The wide products' micro-tiles, where a pass holds P x Hp = 4,096
// outputs: warp w takes points 16 (w % MW) and units 32 (w / MW), MW = P /
// 16 (2 x 4 warps at Hp = 128, 4 x 2 at two tiles of Hp = 64); lane (lm,
// ln) = (lane / 8, lane % 8) takes points m0 + lm + 4 i and units n0 + 4
// ln + j (forward: one float4 of a weight row) or n0 + ln + 8 j (input
// gradient: eight consecutive weight rows a quarter-warp), i, j < 4.
template <int P>
__device__ __forceinline__ int wide_row(int warp, int lane, int i) {
  return 16 * (warp % (P / 16)) + (lane >> 3) + 4 * i;
}
template <int P, bool WT>
__device__ __forceinline__ int wide_col(int warp, int lane, int j) {
  const int n0 = 32 * (warp / (P / 16)), ln = lane & 7;
  return WT ? n0 + ln + 8 * j : n0 + 4 * ln + j;
}

// acc (P x Hp over the block, P Hp = 4,096) = A (P x Hp, swizzled) . B as
// in prod_points, acc[i][j] at (wide_row(i), wide_col<WT>(j)): per 4 k, 4
// float4 loads of A (each a broadcast within its quarter-warp) and 4 of W
// for 64 FMAs.
template <int P, int Hp, bool WT>
__device__ __forceinline__ void prod_wide(const float* A, const float* W,
                                          float (&acc)[4][4]) {
  static_assert(P * Hp == 4096, "a wide pass holds 4,096 outputs");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* Ar[4];
  int sr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = wide_row<P>(warp, lane, i);
    Ar[i] = A + r * Hp;
    sr[i] = swz(r);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  const int c0 = wide_col<P, false>(warp, lane, 0);
#pragma unroll 2
  for (int k4 = 0; k4 < Hp; k4 += 4) {
    float x[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_row<4>(x[i], Ar[i], k4, sr[i]);
    if constexpr (!WT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[4];
        load_row<4>(w, W + (k4 + kk) * Hp, c0, swz(k4 + kk));
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(x[i][kk], w[j], acc[i][j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wide_col<P, true>(warp, lane, j);
        float y[4];
        load_row<4>(y, W + c * Hp, k4, swz(c));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i][j] = fmaf(x[i][kk], y[kk], acc[i][j]);
      }
    }
  }
}

// Weight gradient of hidden layer h over a pass's first n_rows points,
// added to the block's partial row: gW[i][o] (+)= sum_p S[p][i] Gz[p][o]
// (fan-in i as rows, units o as columns, the points summed in order). The
// row's earlier tiles enter as the sum's start. Thread (ri, ci) = (2 warp
// + lane / 16, lane % 16) owns rows [R ri, R ri + R) and columns [R ci, R
// ci + R), R = 2 * NPW.
template <int NPW>
__device__ __forceinline__ void prod_wgrad(const float* S, const float* Gz,
                                           int H, float* grow, bool first,
                                           int n_rows) {
  constexpr int Hp = 32 * NPW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int R = 2 * NPW;
  const int i0 = R * (2 * warp + (lane >> 4)), o0 = R * (lane & 15);
  // four columns of a row move as one 16-byte access where H % 4 == 0
  // (rows and o0 are then 16-byte aligned, and a group of four starting
  // below H ends below it)
  const bool quads = (H & 3) == 0;
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = i0 + a;
    const float* src = grow + (long long)i * H + o0;
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.0f;
    if (first || i >= H) continue;
    if constexpr (R % 4 == 0) {
      if (quads) {
#pragma unroll
        for (int c = 0; c < R; c += 4) {
          if (o0 + c >= H) break;
          const float4 u = __ldcg(reinterpret_cast<const float4*>(src + c));
          acc[a][c] = u.x; acc[a][c + 1] = u.y;
          acc[a][c + 2] = u.z; acc[a][c + 3] = u.w;
        }
        continue;
      }
    }
#pragma unroll
    for (int b = 0; b < R; ++b)
      if (o0 + b < H) acc[a][b] = __ldcg(src + b);
  }
  // (at H padded to 96 one point a step: two unrolled spill registers)
#pragma unroll (NPW == 3 ? 1 : 2)
  for (int pp = 0; pp < n_rows; ++pp) {
    float sv[R], gv[R];
    load_row<R>(sv, S + pp * Hp, i0, swz(pp));
    load_row<R>(gv, Gz + pp * Hp, o0, swz(pp));
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) acc[a][b] = fmaf(sv[a], gv[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = i0 + a;
    if (i >= H) continue;
    float* dst = grow + (long long)i * H + o0;
    if constexpr (R % 4 == 0) {
      if (quads) {
#pragma unroll
        for (int c = 0; c < R; c += 4) {
          if (o0 + c >= H) break;
          __stcg(reinterpret_cast<float4*>(dst + c),
                 make_float4(acc[a][c], acc[a][c + 1], acc[a][c + 2],
                             acc[a][c + 3]));
        }
        continue;
      }
    }
#pragma unroll
    for (int b = 0; b < R; ++b)
      if (o0 + b < H) __stcg(dst + b, acc[a][b]);
  }
}

// Sum of v over R consecutive lanes (R a power of two dividing 32), the
// same in each of them: a butterfly pairs the same two values in every
// lane, so the order is fixed.
template <int R>
__device__ __forceinline__ float col_sum(float v) {
#pragma unroll
  for (int s = R / 2; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// An entry of the block's partial row plus a pass's first tile's sum v (v
// alone for the block's first tile); the pass's later tiles' sums are
// added to it in order, and it is stored once.
__device__ __forceinline__ float row_start(const float* dst, float v,
                                           bool first) {
  return first ? v : __ldcg(dst) + v;
}

// NPW: H padded to 32 * NPW. RC: the plan's recompute, fixed at compile
// time so that the store path carries none of the stash's code. NTP: the
// plan's pass_tiles.
template <int NPW, bool RC, int NTP>
__global__ void __launch_bounds__(NT, 1) fit_persistent(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Plan& p = a.p;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int Hp = 32 * NPW;            // H padded (fit_run checks p.Hp)
  constexpr int P = NTP * T;              // points a pass
  constexpr int PH = P * Hp;
  constexpr bool WIDE = PH == 4096;       // 4 x 4 micro-tiles (prod_wide)
  static_assert(!RC || NTP == 1, "a recompute plan takes one tile a pass");
  // threads that share one column in the column sums over a tile's
  // points: the largest power of two with CR * Hp <= NT
  constexpr int CR = NT / Hp >= 8 ? 8 : NT / Hp >= 4 ? 4 : NT / Hp >= 2 ? 2 : 1;
  const int H = p.H, Lh = p.Lh, Di = p.D_in, Do = p.D_out;
  const Smem L = smem_layout(p);
  const int b = blockIdx.x;
  const Act act{sm + L.act, a.zstash + (long long)b * (Lh + 1) * PH, PH, Lh,
                RC};
  float* wbuf = sm + L.wbuf;
  float* bh = sm + L.bh;
  const float* fs = sm + L.fs;      // w0[k][o] = fs[k H + o], b0 = fs + Di H
  const float* hs = sm + L.hs;      // wo[k][e] = hs[k Do + e], bo = hs + H Do
  float* X = sm + L.X;
  float* GR = sm + L.GR;
  float* red = sm + L.red;
  float* rsum = sm + L.rsum;

  const int tile0 = b * p.tiles_per_block;
  const int tile1 = b < p.n_work ? min(tile0 + p.tiles_per_block, p.n_tiles)
                                 : tile0;
  const long long q0 = min((long long)b * p.chunk, p.n_params);
  const long long q1 = min(q0 + p.chunk, p.n_params);
  float* prow = a.part + (long long)b * p.ld_part;

  // The pass's tiles (up to NTP, the block's last pass may hold fewer)
  // and its points in the batch.
  auto tiles_in = [&](int tile) { return min(NTP, tile1 - tile); };
  auto points_in = [&](int tile) {
    return min(tiles_in(tile) * T, p.B - tile * T);
  };
  // A pass's pool data into X, PA, PC, PT, PW (one cp.async group); rows
  // past its points get x = 0 (finite activations, and GR = 0 drops them).
  auto fetch_pool = [&](int it, int tile) {
    const long long j = it % p.K, q = j * p.B + (long long)tile * T;
    const int n_pts = points_in(tile);
    for (int e = tid; e < P * Di; e += NT) {
      const int pp = e / Di, k = e - pp * Di;
      if (pp < n_pts) cp_async4(X + pp * 4 + k, a.x + q * Di + e);
      else X[pp * 4 + k] = 0.0f;
    }
    for (int e = tid; e < n_pts * Do * Do; e += NT)
      cp_async4(sm + L.PA + e, a.A + q * Do * Do + e);
    for (int e = tid; e < n_pts * Do; e += NT) {
      cp_async4(sm + L.PC + e, a.c + q * Do + e);
      cp_async4(sm + L.PT + e, a.tgt + q * Do + e);
    }
    for (int e = tid; e < n_pts; e += NT) cp_async4(sm + L.PW + e, a.w + q + e);
    cp_async_commit();
  };

  // Zero all shared memory once: the padding of the weights stays zero
  // (only the valid region is ever written), and m, v start at zero.
  for (long long e = tid; e < L.total; e += NT) sm[e] = 0.0f;
  __syncthreads();
  if (tile0 < tile1) fetch_pool(0, tile0);

  unsigned bar_target = 0;
  double p1 = 1.0, p2 = 1.0;
  const bool timed = a.phases != nullptr && b == 0 && tid == 0;
  long long t_mark = timed ? clock64() : 0;
  const long long t_start = t_mark;
  const unsigned long long ns_start = timed ? global_ns() : 0;
  // an integer reduction: the timing thread does not wait for it
  auto mark = [&](int phase) {
    if (timed) {
      const long long t = clock64();
      atomicAdd(reinterpret_cast<unsigned long long*>(a.phases + phase),
                (unsigned long long)(t - t_mark));
      t_mark = t;
    }
  };
  for (int it = 0; it < p.n_iters; ++it) {
    if (tile0 < tile1) {
      // ---- (a) first layer and head from L2 (the hidden layers follow
      // one at a time)
      stage_flat(sm + L.fs, a.params, (Di + 1) * H, H);
      stage_flat(sm + L.hs, a.params + off_out(p), Do * (H + 1), H);
      cp_async_commit();
      int held0 = -1, held1 = -1;      // hidden weight held by each buffer
      // stage hidden weight h unless its buffer holds it; commits a group
      auto fetch = [&](int h) {
        const int s = h % p.n_wbuf;
        int& held = s ? held1 : held0;
        if (held != h) {
          stage_hidden<Hp>(wbuf + (long long)s * Hp * Hp, bh + s * Hp,
                           a.params, p, h);
          held = h;
        } else {
          cp_async_commit();
        }
      };
      auto wslot = [&](int h) {
        return wbuf + (long long)(h % p.n_wbuf) * Hp * Hp;
      };
      float lblock = 0.0f;

      for (int tile = tile0; tile < tile1; tile += NTP) {
        const bool first = tile == tile0;
        const int nt = NTP == 1 ? 1 : tiles_in(tile);
        const int n_pts = points_in(tile);
        if (Lh > 0) fetch(0);
        if (Lh > 0) cp_async_wait_prior(); else cp_async_wait_all();
        __syncthreads();                    // pool data and first layer in

        // ---- forward: first layer on the CUDA cores
        for (int e = tid; e < PH; e += NT) {
          const int pp = e / Hp, o = e - pp * Hp;
          float z = 0.0f;
          if (o < H) {
            z = fs[Di * H + o];
#pragma unroll
            for (int k = 0; k < 3; ++k)
              if (k < Di) z = fmaf(X[pp * 4 + k], fs[k * H + o], z);
          }
          put_act(act, 0, sw(pp, o, Hp), z);
        }
        mark(PH_FIRST);
        // ---- forward: hidden layers
        for (int h = 0; h < Lh; ++h) {
          cp_async_wait_all();
          __syncthreads();                  // W[h] landed, S(h) complete
          if (p.n_wbuf == 2 && h + 1 < Lh) fetch(h + 1);
          const float* bias = bh + (h % p.n_wbuf) * Hp;
          if constexpr (WIDE) {
            float acc[4][4];
            prod_wide<P, Hp, false>(act.S(h), wslot(h), acc);
            mark(PH_FWD_PROD);
            const int c0 = wide_col<P, false>(warp, lane, 0);
            float bv[4];
            load_row<4>(bv, bias, c0, 0);
            // four adjacent units of a point: one float4 of S and of C
            // (or of the stash's z)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = wide_row<P>(warp, lane, i);
              const int idx = sw(r, c0, Hp);
              float z[4], sv[4], cv[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                z[j] = acc[i][j] + bv[j];
                sincos30(z[j], sv[j], cv[j]);
              }
              *reinterpret_cast<float4*>(act.S(h + 1) + idx) =
                  make_float4(sv[0], sv[1], sv[2], sv[3]);
              if (RC)
                __stcg(reinterpret_cast<float4*>(act.Z(h + 1) + idx),
                       make_float4(z[0], z[1], z[2], z[3]));
              else
                *reinterpret_cast<float4*>(act.C(h + 1) + idx) =
                    make_float4(cv[0], cv[1], cv[2], cv[3]);
            }
          } else {
            float acc[NPW][4];
            prod_points<NPW, false>(act.S(h), wslot(h), acc);
            mark(PH_FWD_PROD);
#pragma unroll
            for (int jj = 0; jj < NPW; ++jj) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = (warp & 1) * 16 + g + ((e & 2) ? 8 : 0);
                const int cc = out_col<NPW, false>(warp, t4, jj, e);
                put_act(act, h + 1, sw(r, cc, Hp), acc[jj][e] + bias[cc]);
              }
            }
          }
          if (p.n_wbuf == 1 && h + 1 < Lh) {
            __syncthreads();                // every warp is done with W[h]
            fetch(h + 1);
          }
          mark(PH_FWD_EPI);
        }
        __syncthreads();                    // S(Lh) complete
        if (RC) {                           // z of the top two layers back
          unstash(act, Lh);
          if (Lh > 0) unstash(act, Lh - 1);
        }
        mark(PH_FWD_EPI);

        // ---- head, hard-BC affine map, weighted residual: 8 threads a
        // point, a tile at a time (one copy of the code: fewer registers)
#pragma unroll 1
        for (int tt = 0; tt < NTP; ++tt) {
          const int pp = tt * T + (tid >> 3), q = tid & 7;
          const float* SL = act.S(Lh);
          // (loops over D_in, D_out run to 3 with a guard, so that the
          // small arrays stay in registers)
          float r3[3] = {0.0f, 0.0f, 0.0f};
          for (int k = q; k < H; k += 8) {
            const float hv = SL[sw(pp, k, Hp)];
#pragma unroll
            for (int e = 0; e < 3; ++e)
              if (e < Do) r3[e] = fmaf(hv, hs[k * Do + e], r3[e]);
          }
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            // butterfly: every lane of the 8 ends with the same sum
            r3[e] += __shfl_xor_sync(0xffffffffu, r3[e], 4);
            r3[e] += __shfl_xor_sync(0xffffffffu, r3[e], 2);
            r3[e] += __shfl_xor_sync(0xffffffffu, r3[e], 1);
          }
          float lp = 0.0f;
          if (q == 0) {
            float gr[3] = {0.0f, 0.0f, 0.0f};
            if (pp < n_pts) {
              const float* Ap = sm + L.PA + pp * Do * Do;
              float raw[3], gu[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int e = 0; e < 3; ++e)
                raw[e] = e < Do ? r3[e] + hs[H * Do + e] : 0.0f;
              const float wp = sm[L.PW + pp];
#pragma unroll
              for (int dd = 0; dd < 3; ++dd) {
                if (dd >= Do) break;
                float u = sm[L.PC + pp * Do + dd];
#pragma unroll
                for (int e = 0; e < 3; ++e)
                  if (e < Do) u += Ap[dd * Do + e] * raw[e];
                const float r = u - sm[L.PT + pp * Do + dd];
                lp += wp * r * r;
                gu[dd] = 2.0f * wp * r;
              }
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                float s = 0.0f;
#pragma unroll
                for (int dd = 0; dd < 3; ++dd)
                  if (e < Do && dd < Do) s += Ap[dd * Do + e] * gu[dd];
                gr[e] = s;
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) GR[pp * 4 + e] = e < 3 ? gr[e] : 0.0f;
          }
          for (int s = 16; s > 0; s >>= 1)
            lp += __shfl_xor_sync(0xffffffffu, lp, s);
          if (lane == 0) red[tt * (NT / 32) + warp] = lp;
        }
        if (RC) cp_async_wait_all();
        __syncthreads();
        if (tid == 0) {
#pragma unroll
          for (int tt = 0; tt < NTP && tt < nt; ++tt) {
            float s = 0.0f;
            for (int ww = 0; ww < NT / 32; ++ww) s += red[tt * (NT / 32) + ww];
            lblock = first && tt == 0 ? s : lblock + s;
          }
        }

        // ---- backward: head (CUDA cores); each column sum a tile at a
        // time, added to the row in tile order
        {
          const float* SL = act.S(Lh);
          const long long oo = off_out(p);
          if (tid < CR * Hp) {              // gW_out[k][e]
            const int k = tid / CR, part = tid % CR;
            const bool mine = part == 0 && k < H;
            float* dst = prow + oo + k * Do;
            float r3[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int tt = 0; tt < NTP && tt < nt; ++tt) {
              float s3[3] = {0.0f, 0.0f, 0.0f};
              for (int pp = tt * T + part; pp < (tt + 1) * T; pp += CR) {
                const float hv = SL[sw(pp, k, Hp)];
#pragma unroll
                for (int e = 0; e < 3; ++e)
                  s3[e] = fmaf(hv, GR[pp * 4 + e], s3[e]);
              }
#pragma unroll
              for (int e = 0; e < 3; ++e) {
                s3[e] = col_sum<CR>(s3[e]);
                if (mine && e < Do)
                  r3[e] = tt ? r3[e] + s3[e] : row_start(dst + e, s3[e], first);
              }
            }
#pragma unroll
            for (int e = 0; e < 3; ++e)
              if (mine && e < Do) __stcg(dst + e, r3[e]);
          }
          if (warp == NT / 32 - 1) {        // gb_out: a lane a point
            float* dst = prow + oo + H * Do;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              float r = 0.0f;
#pragma unroll
              for (int tt = 0; tt < NTP && tt < nt; ++tt) {
                const float s = col_sum<32>(GR[(tt * T + lane) * 4 + e]);
                r = tt ? r + s : (lane == 0 && e < Do
                                      ? row_start(dst + e, s, first) : s);
              }
              if (lane == 0 && e < Do) __stcg(dst + e, r);
            }
          }
          // g_z of the last hidden layer into C(Lh)
          float* CL = act.C(Lh);
          for (int e = tid; e < PH; e += NT) {
            const int pp = e / Hp, k = e - pp * Hp;
            float s = 0.0f;
            if (k < H)
#pragma unroll
              for (int ee = 0; ee < 3; ++ee)
                if (ee < Do) s = fmaf(hs[k * Do + ee], GR[pp * 4 + ee], s);
            const int idx = sw(pp, k, Hp);
            float cz = CL[idx];
            if (RC) {
              float sz;
              sincosf(OMEGA * cz, &sz, &cz);
            }
            CL[idx] = s * (OMEGA * cz);
            if (RC && Lh > 0) prepare(act, Lh - 1, idx);
          }
        }
        mark(PH_HEAD);

        // ---- backward: hidden layers, last to first
        for (int h = Lh - 1; h >= 0; --h) {
          cp_async_wait_all();
          __syncthreads();                  // g_z(h+1) complete, W[h] landed
          if (p.n_wbuf == 2 && h >= 1) fetch(h - 1);
          if (RC && h >= 1) unstash(act, h - 1);
          const float* gz = act.C(h + 1);
          float* grow = prow + off_hid(p, h);
          if (tid < CR * Hp) {              // bias gradient
            const int o = tid / CR, part = tid % CR;
            const bool mine = part == 0 && o < H;
            float* dst = grow + H * H + o;
            float r = 0.0f;
#pragma unroll
            for (int tt = 0; tt < NTP && tt < nt; ++tt) {
              float s = 0.0f;
              for (int pp = tt * T + part; pp < (tt + 1) * T; pp += CR)
                s += gz[sw(pp, o, Hp)];
              s = col_sum<CR>(s);
              if (mine) r = tt ? r + s : row_start(dst, s, first);
            }
            if (mine) __stcg(dst, r);
          }
          prod_wgrad<NPW>(act.S(h), gz, H, grow, first,
                          NTP == 1 ? T : nt * T);
          mark(PH_BWD_WGRAD);
          float* Cb = act.C(h);
          if constexpr (WIDE) {
            float acc[4][4];
            prod_wide<P, Hp, true>(gz, wslot(h), acc);
            if (RC && h >= 1) {
              cp_async_wait_all();
              __syncthreads();              // z of layer h - 1 in C(h - 1)
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int idx = sw(wide_row<P>(warp, lane, i),
                                   wide_col<P, true>(warp, lane, j), Hp);
                Cb[idx] = acc[i][j] * (OMEGA * Cb[idx]);
              }
            // (a loop of its own, not unrolled: one sincosf in the code)
            if (RC && h > 0)
#pragma unroll 1
              for (int q = 0; q < 16; ++q)
                prepare(act, h - 1,
                        sw(wide_row<P>(warp, lane, q >> 2),
                           wide_col<P, true>(warp, lane, q & 3), Hp));
          } else {
            float acc[NPW][4];
            prod_points<NPW, true>(gz, wslot(h), acc);
            if (RC && h >= 1) {
              cp_async_wait_all();
              __syncthreads();              // z of layer h - 1 in C(h - 1)
            }
#pragma unroll
            for (int jj = 0; jj < NPW; ++jj)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = (warp & 1) * 16 + g + ((e & 2) ? 8 : 0);
                const int idx = sw(r, out_col<NPW, true>(warp, t4, jj, e), Hp);
                Cb[idx] = acc[jj][e] * (OMEGA * Cb[idx]);
              }
            if (RC && h > 0)
#pragma unroll 1
              for (int q = 0; q < 4 * NPW; ++q) {
                const int r = (warp & 1) * 16 + g + ((q & 2) ? 8 : 0);
                prepare(act, h - 1,
                        sw(r, out_col<NPW, true>(warp, t4, q >> 2, q & 3), Hp));
              }
          }
          if (p.n_wbuf == 1 && h >= 1) {
            __syncthreads();                // every warp is done with W[h]
            fetch(h - 1);
          }
          mark(PH_BWD_IGRAD);
        }
        __syncthreads();                    // g_z(0) complete
        mark(PH_BWD_IGRAD);

        // ---- backward: first layer (CUDA cores)
        if (tid < CR * Hp) {
          const float* C0 = act.C(0);
          const int o = tid / CR, part = tid % CR;
          const bool mine = part == 0 && o < H;
          float rw[3] = {0.0f, 0.0f, 0.0f}, rb = 0.0f;
#pragma unroll
          for (int tt = 0; tt < NTP && tt < nt; ++tt) {
            float sw3[3] = {0.0f, 0.0f, 0.0f}, sb = 0.0f;
            for (int pp = tt * T + part; pp < (tt + 1) * T; pp += CR) {
              const float gzv = C0[sw(pp, o, Hp)];
              sb += gzv;
#pragma unroll
              for (int k = 0; k < 3; ++k)
                sw3[k] = fmaf(X[pp * 4 + k], gzv, sw3[k]);
            }
            sb = col_sum<CR>(sb);
#pragma unroll
            for (int k = 0; k < 3; ++k) sw3[k] = col_sum<CR>(sw3[k]);
            if (mine) {
#pragma unroll
              for (int k = 0; k < 3; ++k)
                if (k < Di)
                  rw[k] = tt ? rw[k] + sw3[k]
                             : row_start(prow + k * H + o, sw3[k], first);
              rb = tt ? rb + sb
                      : row_start(prow + (long long)Di * H + o, sb, first);
            }
          }
          if (mine) {
#pragma unroll
            for (int k = 0; k < 3; ++k)
              if (k < Di) __stcg(prow + k * H + o, rw[k]);
            __stcg(prow + (long long)Di * H + o, rb);
          }
        }
        __syncthreads();                    // buffers free for the next pass
        // the next pass's pool data, in flight while this block finishes
        // the pass or waits at the barriers
        if (tile + NTP < tile1) fetch_pool(it, tile + NTP);
        else if (it + 1 < p.n_iters) fetch_pool(it + 1, tile0);
        mark(PH_BWD_FIRST);
      }
      if (tid == 0) __stcg(a.loss_part + b, lblock);
    }

    // ---- (d) every partial row is written
    grid_barrier(a.barrier, p.G, bar_target);
    mark(PH_WAIT_D);

    // ---- (e) Adam on this block's slice [q0, q1)
    p1 *= (double)B1;
    p2 *= (double)B2;
    const float lr = __ldg(a.lr + it);
    const float bc1 = (float)(1.0 - p1), bc2 = (float)(1.0 - p2);
    // in passes of pass_cols columns [s0, s0 + pass_cols)
    for (long long s0 = q0; s0 < q1; s0 += p.pass_cols) {
      // the pass's columns of the n_work rows, summed in row groups (the
      // rows of a group in block order, then the groups in order); each
      // thread keeps up to 8 row loads in flight
      const int n4 = p.pass_cols >> 2, RG = p.row_groups;
      const int rpg = (p.n_work + RG - 1) / RG;
      float4* rs4 = reinterpret_cast<float4*>(rsum);
      for (int e = tid; e < RG * n4; e += NT) {
        const int grp = e / n4, c4 = e - grp * n4;
        const long long col = s0 + 4LL * c4;
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (col < q1) {
          const int r1 = min((grp + 1) * rpg, p.n_work);
#pragma unroll 8
          for (int r = grp * rpg; r < r1; ++r) {
            const float4 u = __ldcg(reinterpret_cast<const float4*>(
                a.part + (long long)r * p.ld_part + col));
            s.x += u.x; s.y += u.y; s.z += u.z; s.w += u.w;
          }
        }
        rs4[e] = s;
      }
      __syncthreads();
      const int n_cols = (int)min((long long)p.pass_cols, q1 - s0);
      // m and v of the pass's columns: m[e], v[e]
      auto adam = [&](float* m, float* v) {
        for (int e = tid; e < n_cols; e += NT) {
          float gs = 0.0f;
          for (int grp = 0; grp < RG; ++grp)
            gs += rsum[grp * p.pass_cols + e];
          const float mj = (1.0f - B1) * gs + B1 * m[e];
          const float vj = (1.0f - B2) * (gs * gs) + B2 * v[e];
          m[e] = mj;
          v[e] = vj;
          float* pp = a.params + s0 + e;
          __stcg(pp, __ldcg(pp) - lr * ((mj / bc1) / (sqrtf(vj / bc2) + ADAM_EPS)));
        }
      };
      // the moments of the block's slice, m | v: on chip unless the plan
      // keeps them in global memory (each call sees one memory space)
      const long long j0 = s0 - q0;
      if (p.moments_global) {
        float* m = a.moments + 2LL * b * p.chunk;
        adam(m + j0, m + p.chunk + j0);
      } else {
        adam(sm + L.m + j0, sm + L.m + p.chunk + j0);
      }
      if (s0 + p.pass_cols < q1) __syncthreads();   // rsum is reused
    }
    mark(PH_ADAM);
    if (it == p.n_iters - 1) {
      if (b == 0 && tid == 0) {
        float s = 0.0f;
        for (int r = 0; r < p.n_work; ++r) s += __ldcg(a.loss_part + r);
        *a.loss_out = s;
      }
    } else {
      // ---- (f) every slice is updated before the next iteration reads it
      grid_barrier(a.barrier, p.G, bar_target);
      mark(PH_WAIT_F);
    }
  }
  if (timed) {
    a.phases[N_PHASES] = clock64() - t_start;
    a.phases[N_PHASES + 1] = (long long)(global_ns() - ns_start);
  }
}

template <int NPW, bool RC, int NTP>
int launch(const Args& args, cudaStream_t stream) {
  const Plan& p = args.p;
  cudaError_t err = cudaFuncSetAttribute(
      fit_persistent<NPW, RC, NTP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem_bytes);
  if (err == cudaSuccess) {
    void* kargs[] = {const_cast<Args*>(&args)};
    err = cudaLaunchCooperativeKernel(
        (const void*)fit_persistent<NPW, RC, NTP>, dim3(p.G), dim3(NT),
        kargs, (size_t)p.smem_bytes, stream);
  }
  // read the runtime's last error even on failure: a refused launch must
  // not stay behind for the next caller's check
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// two tiles a pass only at H padded to 64 with sin and cos kept (fit_run
// checks)
template <bool RC>
int launch_npw(const Args& args, cudaStream_t stream) {
  switch (args.p.Hp / 32) {
    case 1: return launch<1, RC, 1>(args, stream);
    case 2:
      if constexpr (!RC)
        if (args.p.pass_tiles == 2) return launch<2, false, 2>(args, stream);
      return launch<2, RC, 1>(args, stream);
    case 3: return launch<3, RC, 1>(args, stream);
    default: return launch<4, RC, 1>(args, stream);
  }
}

}  // namespace

extern "C" {

// Runs a whole fit (n_iters Adam iterations) as one cooperative launch on
// `stream`. params (padded to ld_part floats) is updated in place. plan is
// the int64 array of sim/fitkernel.py::fit_plan (n_plan fields). part is
// the (n_work, ld_part) partial-gradient scratch, loss_part (n_work,), lr
// (n_iters,) on the device, barrier one zeroed uint32; zstash the
// (n_work, Lh + 1, 32, Hp) stash of a recompute plan, moments the zeroed
// (G, 2, chunk) Adam moments of a moments_global plan (else null); phases
// null, or N_PHASES + 2 zeroed int64 for block 0's phase times (Phase).
// Returns the first CUDA error (cudaErrorCooperativeLaunchTooLarge when
// the grid cannot be co-resident), or cudaErrorInvalidValue for a plan
// this file rejects.
int fit_run(float* params, const float* x, const float* A, const float* c,
            const float* tgt, const float* w, const float* lr, float* part,
            float* loss_part, float* loss_out, unsigned* barrier,
            float* zstash, float* moments, long long* phases,
            const long long* plan, int n_plan, cudaStream_t stream) {
  if (n_plan != N_PLAN_FIELDS) return (int)cudaErrorInvalidValue;
  Args a;
  a.params = params; a.x = x; a.A = A; a.c = c; a.tgt = tgt; a.w = w;
  a.lr = lr; a.part = part; a.loss_part = loss_part; a.loss_out = loss_out;
  a.barrier = barrier; a.zstash = zstash; a.moments = moments;
  a.phases = phases;
  Plan& p = a.p;
  p.D_in = (int)plan[F_D_IN]; p.D_out = (int)plan[F_D_OUT];
  p.H = (int)plan[F_H]; p.Lh = (int)plan[F_LH]; p.B = (int)plan[F_B];
  p.K = (int)plan[F_K]; p.n_iters = (int)plan[F_N_ITERS];
  p.Hp = (int)plan[F_HP]; p.n_params = plan[F_N_PARAMS];
  p.n_tiles = (int)plan[F_N_TILES];
  p.tiles_per_block = (int)plan[F_TILES_PER_BLOCK];
  p.pass_tiles = (int)plan[F_PASS_TILES];
  p.n_work = (int)plan[F_N_WORK]; p.G = (int)plan[F_G];
  p.chunk = (int)plan[F_CHUNK]; p.pass_cols = (int)plan[F_PASS_COLS];
  p.n_wbuf = (int)plan[F_N_WBUF]; p.recompute = (int)plan[F_RECOMPUTE];
  p.moments_global = (int)plan[F_MOMENTS_GLOBAL];
  p.ld_part = plan[F_LD_PART];
  p.row_groups = (int)plan[F_ROW_GROUPS]; p.smem_bytes = plan[F_SMEM_BYTES];
  // the plan is computed in Python; reject one this kernel cannot run
  const long long n_params = (long long)p.D_in * p.H + p.H
      + (long long)p.Lh * (p.H * p.H + p.H) + (long long)p.H * p.D_out
      + p.D_out;
  if (p.D_in < 1 || p.D_in > 3 || p.D_out < 1 || p.D_out > 3 || p.H < 1
      || p.Hp < p.H || p.Hp % 32 || p.Hp > 128 || p.Lh < 0
      || p.n_params != n_params || p.chunk % 4 || p.ld_part % 4
      || p.ld_part < p.n_params || p.pass_cols < 4 || p.pass_cols % 4
      || p.pass_cols > p.chunk || p.n_wbuf < 1 || p.n_wbuf > 2
      || p.row_groups < 1 || p.G < p.n_work
      || (long long)p.G * p.chunk < p.n_params
      || (long long)p.n_work * p.tiles_per_block < p.n_tiles
      || (long long)p.n_tiles * T < p.B
      || (p.pass_tiles != 1
          && (p.pass_tiles != 2 || p.Hp != 64 || p.recompute))
      || (p.recompute && !zstash) || (p.moments_global && !moments)
      || 4 * smem_layout(p).total != p.smem_bytes)
    return (int)cudaErrorInvalidValue;
  return p.recompute ? launch_npw<true>(a, stream)
                     : launch_npw<false>(a, stream);
}

const char* fit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

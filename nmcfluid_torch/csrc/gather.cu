// Gather probe kernels for NVIDIA Hopper (sm_90a): out[b] = table[idx[b]].
//
// Replaces the four TPU kernels of nmcfluid/wost/pallas_probe.py::gather_rows
// (_rows_kernel, _lanes_kernel, _scalar_kernel, _onehot_kernel). On the TPU
// they were the candidate ways for a walk kernel to read the quad-packed
// radial table (R = 32512 rows of 4 floats, 520 KB); on the card they measure
// the rate of the walk's per-lane gather in the same four forms.
//
//   gather_rows_k    one thread per output row: one 16-byte (float4) load
//                    from the table and one 16-byte store.
//   gather_lanes_k   the table transposed to (4, R) and the output (4, n):
//                    one thread per index b reads table_t[q][idx[b]] and
//                    writes out_t[q][b], so the four stores of a warp are
//                    coalesced along n.
//   gather_scalar_k  one thread per 1024-index block (the TPU grid step)
//                    copies its rows one after another: the serial worst
//                    case the TPU variant bounded.
//   gather_onehot_k  the TPU's one-hot form: i0 = idx / 256, j0 = idx % 256;
//                    the one-hot product over the 128 Z rows of the padded
//                    (128, 1024) table, taken as f32 FMAs on the column
//                    4 j0 + q that the TPU kernel's masked lane sum picks.
//                    Exact: one term of each sum is nonzero, and there is
//                    no TF32 and no library product. Not gather-free: the
//                    masked sum over 1024 lanes became a per-lane address,
//                    so each lane makes 128 strided float4 loads down its
//                    column.
//
// What bounds them on the card: bytes. Each call reads n int32 indices and
// writes n 16-byte rows; the table stays resident in the 50 MB L2, so HBM
// sees at most its 520 KB once. At the probe's n = 65,536 that is ~1.3 MB,
// below a microsecond at 3.35 TB/s, so launch latency dominates; onehot
// adds 128 x 4 FMAs a lane (67 MFLOP at n = 65,536) and 128 float4 loads a
// lane from L1/L2. The design is the simple one; speed is measured in
// chip_smoke.py and PERF.md, not designed for.
//
// Every kernel applies the probe's repeat offset, i = (idx[b] + offset) % R,
// so that timed repeats read other rows, as the JAX probe's (idx + k) % R.
// Indices must lie in [0, R): the kernels do not check them, the wrapper
// (wost/pallas_probe.py::gather_rows) does.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads per block (rows, lanes, onehot)
constexpr int BLOCK = 1024;      // indices per TPU grid step (scalar)
constexpr int ONEHOT_Z = 128;    // padded Z rows of the onehot table
constexpr int ONEHOT_J = 256;    // quad columns per Z row
constexpr int ONEHOT_W = ONEHOT_J * 4;   // floats per padded Z row

__device__ __forceinline__ int row_of(const int* idx, int b, int offset,
                                      int R) {
  const int i = idx[b];
  return offset == 0 ? i : (int)(((long long)i + offset) % R);
}

__global__ void gather_rows_k(const float4* __restrict__ table,
                              const int* __restrict__ idx,
                              float4* __restrict__ out, int n, int R,
                              int offset) {
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= n) return;
  out[b] = table[row_of(idx, b, offset, R)];
}

__global__ void gather_lanes_k(const float* __restrict__ table_t,
                               const int* __restrict__ idx,
                               float* __restrict__ out_t, int n, int R,
                               int offset) {
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= n) return;
  const int i = row_of(idx, b, offset, R);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out_t[(long long)q * n + b] = table_t[(long long)q * R + i];
}

__global__ void gather_scalar_k(const float4* __restrict__ table,
                                const int* __restrict__ idx,
                                float4* __restrict__ out, int n, int R,
                                int offset) {
  const int base = blockIdx.x * BLOCK;
  if (base >= n) return;
  for (int k = 0; k < BLOCK; ++k)
    out[base + k] = table[row_of(idx, base + k, offset, R)];
}

__global__ void gather_onehot_k(const float* __restrict__ table2d,
                                const int* __restrict__ idx,
                                float4* __restrict__ out, int n, int R,
                                int offset) {
  const int b = blockIdx.x * NT + threadIdx.x;
  if (b >= n) return;
  const int i = row_of(idx, b, offset, R);
  const int i0 = i / ONEHOT_J;
  const int j0 = i - i0 * ONEHOT_J;
  const float4* col = reinterpret_cast<const float4*>(table2d) + j0;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < ONEHOT_Z; ++z) {
    const float hot = z == i0 ? 1.f : 0.f;
    const float4 t = col[z * (ONEHOT_W / 4)];
    acc.x = fmaf(hot, t.x, acc.x);
    acc.y = fmaf(hot, t.y, acc.y);
    acc.z = fmaf(hot, t.z, acc.z);
    acc.w = fmaf(hot, t.w, acc.w);
  }
  out[b] = acc;
}

}  // namespace

extern "C" {

// Launches `reps` gathers of one variant on `stream`, the r-th with offset
// r (r = 0 .. reps - 1), all writing `out`. variant: 0 rows, 1
// lanes, 2 scalar, 3 onehot. `table` is the (R, 4) table for rows and
// scalar, its (4, R) transpose for lanes, and the padded (128, 1024) table
// for onehot; `out` is (n, 4), or (4, n) for lanes. n is a multiple of
// 1024. Returns the first CUDA error, or -1 for an unknown variant.
int gather_run(int variant, const float* table, const int* idx, float* out,
               int n, int R, int reps, cudaStream_t stream) {
  const int grid = (n + NT - 1) / NT;
  for (int off = 0; off < reps; ++off) {
    switch (variant) {
      case 0:
        gather_rows_k<<<grid, NT, 0, stream>>>(
            reinterpret_cast<const float4*>(table), idx,
            reinterpret_cast<float4*>(out), n, R, off);
        break;
      case 1:
        gather_lanes_k<<<grid, NT, 0, stream>>>(table, idx, out, n, R, off);
        break;
      case 2:
        gather_scalar_k<<<n / BLOCK, 1, 0, stream>>>(
            reinterpret_cast<const float4*>(table), idx,
            reinterpret_cast<float4*>(out), n, R, off);
        break;
      case 3:
        gather_onehot_k<<<grid, NT, 0, stream>>>(
            table, idx, reinterpret_cast<float4*>(out), n, R, off);
        break;
      default:
        return -1;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"

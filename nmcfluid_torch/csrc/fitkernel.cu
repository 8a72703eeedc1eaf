// Fused Adam phase fit for a SIREN, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nmcfluid/sim/fitkernel.py::_fused_call/_kernel:
// n_iters Adam steps on a SIREN (sin(30 z) hidden layers, linear head)
// over a pool of K fixed minibatches, cycling batch i % K, with the loss
//     sum_p w_p |A_p raw(x_p) + c_p - tgt_p|^2
// (1/norm is folded into w by the wrapper). On the TPU the parameters and
// Adam moments stay in VMEM for the whole loop; on the H100 they do not fit
// one SM's shared memory (Taylor-Green: params + m + v ~ 303 KB against
// 227 KB a block), so each Adam iteration is two kernels, launched by a
// host loop in fit_run():
//
//   fit_fwd_bwd  one block per tile of T points of batch i % K. It stages
//                each layer's weights in shared memory, runs the forward
//                pass keeping sin and cos of every layer in shared memory,
//                applies u = A raw + c and the weighted residual, runs the
//                backward pass by hand and writes its partial gradient and
//                partial loss to row `block` of a (n_blocks, n_params + 1)
//                scratch buffer.
//   fit_adam     one thread per parameter: sums the partials over blocks in
//                block order (reproducible runs), then applies the
//                optax-style Adam update with lr[i] and the 1 - b^t bias
//                corrections. On the last iteration it also sums the loss.
//
// Arithmetic is plain f32 FMA on the CUDA cores with the accurate sincosf
// (no --use_fast_math: __sinf is wrong at |30 z| ~ 300). What bounds it on
// the card: ~0.6 GFLOP of f32 SIMT FMAs per Taylor-Green iteration (6 x 64
// net, 4096 points, forward + backward), and launch overhead at 2 launches
// per iteration. Later work: capture the loop in a CUDA graph, make the fit
// one persistent kernel with a grid-wide barrier, and move the layer
// products onto the tensor cores as a 3xTF32 mma.
//
// Parameter layout (one flat f32 buffer, the JAX package's (fan_in, fan_out)
// row-major weights):
//   w_first (D_in, H) | b_first (H) | Lh x [w_hid (H, H) | b_hid (H)] |
//   w_out (H, D_out) | b_out (D_out)
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int MAXR = 8;      // (point, unit) outputs per thread: T * H <= NT * MAXR
constexpr float OMEGA = 30.0f;
constexpr float B1 = 0.9f;
constexpr float B2 = 0.999f;
constexpr float ADAM_EPS = 1e-8f;

struct Dims {
  int D_in, D_out, H, Lh, T, B;
  long long n_params;
};

__device__ __forceinline__ long long off_hid(const Dims& d, int l) {
  return (long long)d.D_in * d.H + d.H + (long long)l * (d.H * d.H + d.H);
}
__device__ __forceinline__ long long off_out(const Dims& d) {
  return off_hid(d, d.Lh);
}

// Copy a (rows, cols) row-major weight matrix into shared memory with a
// row stride of cols + 1 (conflict-free reads along rows and columns).
__device__ void stage(float* dst, const float* src, int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    int r = e / cols, c = e - r * cols;
    dst[r * (cols + 1) + c] = src[e];
  }
}

// out[p, o] = in[p, :] . W[:, o] + b[o] for the tile's T points, then
// S = sin(30 z), C = cos(30 z). `in` has row stride `fan_in`.
__device__ void dense_sin(const float* in, int fan_in, const float* Wsh,
                          const float* b, float* S, float* C,
                          const Dims& d) {
  const int H = d.H;
  const int n_out = d.T * H;
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    int idx = threadIdx.x + r * NT;
    acc[r] = (idx < n_out) ? b[idx % H] : 0.0f;
  }
  for (int k = 0; k < fan_in; ++k) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      int idx = threadIdx.x + r * NT;
      if (idx < n_out) {
        int p = idx / H, o = idx - p * H;
        acc[r] = fmaf(in[p * fan_in + k], Wsh[k * (H + 1) + o], acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    int idx = threadIdx.x + r * NT;
    if (idx < n_out) {
      float s, c;
      sincosf(OMEGA * acc[r], &s, &c);
      S[idx] = s;
      C[idx] = c;
    }
  }
}

// Weight and bias gradients of one dense layer:
//   gW[k, o] = sum_p in[p, k] gz[p, o],  gb[o] = sum_p gz[p, o]
// for the tile's n_pts valid points, written to the block's partial row.
__device__ void dense_grads(const float* in, int fan_in, const float* gz,
                            int fan_out, int n_pts, float* gW, float* gb) {
  for (int e = threadIdx.x; e < fan_in * fan_out; e += NT) {
    int k = e / fan_out, o = e - k * fan_out;
    float s = 0.0f;
    for (int p = 0; p < n_pts; ++p)
      s = fmaf(in[p * fan_in + k], gz[p * fan_out + o], s);
    gW[e] = s;
  }
  for (int o = threadIdx.x; o < fan_out; o += NT) {
    float s = 0.0f;
    for (int p = 0; p < n_pts; ++p) s += gz[p * fan_out + o];
    gb[o] = s;
  }
}

__global__ void __launch_bounds__(NT)
fit_fwd_bwd(const float* __restrict__ params, const float* __restrict__ x,
            const float* __restrict__ A, const float* __restrict__ c,
            const float* __restrict__ tgt, const float* __restrict__ w,
            float* __restrict__ part, Dims d) {
  extern __shared__ float sm[];
  const int H = d.H, T = d.T, Lh = d.Lh, Di = d.D_in, Do = d.D_out;
  const int TH = T * H;
  const int p0 = blockIdx.x * T;
  const int n_pts = min(T, d.B - p0);
  const int WROW = H > Di ? H : Di;
  float* S = sm;                                   // (Lh+1, T, H) sin
  float* Cc = S + (size_t)(Lh + 1) * TH;           // (Lh+1, T, H) cos
  float* G = Cc + (size_t)(Lh + 1) * TH;           // (T, H) grad wrt h
  float* Wsh = G + TH;                             // (WROW, H+1) weights
  float* X = Wsh + (size_t)WROW * (H + 1);         // (T, D_in)
  float* GR = X + T * Di;                          // (T, D_out) grad raw
  float* red = GR + T * Do;                        // (NT) loss reduction
  float* prow = part + (long long)blockIdx.x * (d.n_params + 1);

  // ---- forward
  for (int e = threadIdx.x; e < T * Di; e += NT) {
    int p = e / Di;
    X[e] = (p < n_pts) ? x[(long long)(p0 + p) * Di + (e - p * Di)] : 0.0f;
  }
  stage(Wsh, params, Di, H);
  __syncthreads();
  dense_sin(X, Di, Wsh, params + (long long)Di * H, S, Cc, d);
  for (int l = 0; l < Lh; ++l) {
    __syncthreads();
    const float* Wl = params + off_hid(d, l);
    stage(Wsh, Wl, H, H);
    __syncthreads();
    dense_sin(S + (size_t)l * TH, H, Wsh, Wl + H * H,
              S + (size_t)(l + 1) * TH, Cc + (size_t)(l + 1) * TH, d);
  }
  __syncthreads();

  // ---- head, hard-BC affine map, weighted residual
  const float* Wo = params + off_out(d);
  const float* bo = Wo + H * Do;
  const float* hL = S + (size_t)Lh * TH;
  float lsum = 0.0f;
  for (int p = threadIdx.x; p < T; p += NT) {
    if (p >= n_pts) {
      for (int e = 0; e < Do; ++e) GR[p * Do + e] = 0.0f;
      continue;
    }
    const long long q = p0 + p;
    float raw[3], gu[3];
    for (int e = 0; e < Do; ++e) {
      float s = bo[e];
      for (int k = 0; k < H; ++k) s = fmaf(hL[p * H + k], Wo[k * Do + e], s);
      raw[e] = s;
    }
    const float wp = w[q];
    for (int dd = 0; dd < Do; ++dd) {
      float u = c[q * Do + dd];
      for (int e = 0; e < Do; ++e)
        u += A[(q * Do + dd) * Do + e] * raw[e];
      float r = u - tgt[q * Do + dd];
      lsum += wp * r * r;
      gu[dd] = 2.0f * wp * r;
    }
    for (int e = 0; e < Do; ++e) {
      float s = 0.0f;
      for (int dd = 0; dd < Do; ++dd) s += A[(q * Do + dd) * Do + e] * gu[dd];
      GR[p * Do + e] = s;
    }
  }
  red[threadIdx.x] = lsum;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) prow[d.n_params] = red[0];

  // ---- backward: head
  dense_grads(hL, H, GR, Do, n_pts, prow + off_out(d),
              prow + off_out(d) + H * Do);
  for (int idx = threadIdx.x; idx < TH; idx += NT) {
    int p = idx / H, k = idx - p * H;
    float s = 0.0f;
    for (int e = 0; e < Do; ++e) s = fmaf(Wo[k * Do + e], GR[p * Do + e], s);
    G[idx] = s;
  }
  __syncthreads();

  // ---- backward: hidden layers, last to first
  for (int l = Lh - 1; l >= 0; --l) {
    float* gz = Cc + (size_t)(l + 1) * TH;        // g_z overwrites cos
    for (int idx = threadIdx.x; idx < TH; idx += NT)
      gz[idx] = G[idx] * (OMEGA * gz[idx]);
    const float* Wl = params + off_hid(d, l);
    stage(Wsh, Wl, H, H);
    __syncthreads();
    dense_grads(S + (size_t)l * TH, H, gz, H, n_pts, prow + off_hid(d, l),
                prow + off_hid(d, l) + H * H);
    // grad wrt the layer's input: G[p, k] = sum_o W[k, o] gz[p, o]
    for (int idx = threadIdx.x; idx < TH; idx += NT) {
      int p = idx / H, k = idx - p * H;
      float s = 0.0f;
      for (int o = 0; o < H; ++o)
        s = fmaf(Wsh[k * (H + 1) + o], gz[p * H + o], s);
      G[idx] = s;
    }
    __syncthreads();
  }

  // ---- backward: first layer
  for (int idx = threadIdx.x; idx < TH; idx += NT)
    Cc[idx] = G[idx] * (OMEGA * Cc[idx]);
  __syncthreads();
  dense_grads(X, Di, Cc, H, n_pts, prow, prow + (long long)Di * H);
}

__global__ void __launch_bounds__(NT)
fit_adam(float* __restrict__ params, float* __restrict__ m,
         float* __restrict__ v, const float* __restrict__ part,
         int n_blocks, long long n_params, float lr, float bc1, float bc2,
         float* __restrict__ loss_out, int write_loss) {
  const long long stride = n_params + 1;
  long long j = (long long)blockIdx.x * NT + threadIdx.x;
  if (j < n_params) {
    float g = 0.0f;
    for (int b = 0; b < n_blocks; ++b) g += part[b * stride + j];
    float mj = (1.0f - B1) * g + B1 * m[j];
    float vj = (1.0f - B2) * (g * g) + B2 * v[j];
    m[j] = mj;
    v[j] = vj;
    params[j] -= lr * ((mj / bc1) / (sqrtf(vj / bc2) + ADAM_EPS));
  }
  if (write_loss && j == 0) {
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += part[b * stride + n_params];
    *loss_out = s;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes fit_fwd_bwd needs for a tile of T points.
long long fit_smem_bytes(int D_in, int D_out, int H, int Lh, int T) {
  const int WROW = H > D_in ? H : D_in;
  long long f = 2LL * (Lh + 1) * T * H + (long long)T * H
                + (long long)WROW * (H + 1) + (long long)T * D_in
                + (long long)T * D_out + NT;
  return f * (long long)sizeof(float);
}

// Runs n_iters Adam iterations (two launches each) on `stream`. params, m
// and v are updated in place; m and v must start at zero. lr_host holds the
// n_iters learning rates, read on the host. part is the
// (ceil(B / T), n_params + 1) scratch buffer. Returns the first CUDA error.
int fit_run(float* params, float* m, float* v, const float* x,
            const float* A, const float* c, const float* tgt,
            const float* w, const float* lr_host, float* part,
            float* loss_out, int n_iters, int K, int B, int D_in, int D_out,
            int H, int Lh, int T, cudaStream_t stream) {
  Dims d;
  d.D_in = D_in; d.D_out = D_out; d.H = H; d.Lh = Lh; d.T = T; d.B = B;
  d.n_params = (long long)D_in * H + H + (long long)Lh * (H * H + H)
               + (long long)H * D_out + D_out;
  const int n_blocks = (B + T - 1) / T;
  const size_t smem = (size_t)fit_smem_bytes(D_in, D_out, H, Lh, T);
  cudaError_t err = cudaFuncSetAttribute(
      fit_fwd_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int adam_blocks = (int)((d.n_params + NT - 1) / NT);
  double p1 = 1.0, p2 = 1.0;
  for (int i = 0; i < n_iters; ++i) {
    const long long j = i % K;
    fit_fwd_bwd<<<n_blocks, NT, smem, stream>>>(
        params, x + j * B * D_in, A + j * B * D_out * D_out,
        c + j * B * D_out, tgt + j * B * D_out, w + j * B, part, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    p1 *= (double)B1;
    p2 *= (double)B2;
    fit_adam<<<adam_blocks, NT, 0, stream>>>(
        params, m, v, part, n_blocks, d.n_params, lr_host[i],
        (float)(1.0 - p1), (float)(1.0 - p2), loss_out,
        i == n_iters - 1 ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"

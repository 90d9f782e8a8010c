// Bagged-forest inference for Hopper (sm_90a): ensemble mean and spread
// of one forest over M query points, one thread per point.
//
// Replaces the TPU kernel `tree_predict_call` / `_kernel` of
// src/repro/kernels/tree_predict/kernel.py (pallas_call at line 88).  For
// every point it descends the B complete binary trees of depth D (node id
// `pos % W` at every level, an +inf threshold routes left), and writes
// mu = mean of the B leaf values and sigma = max(sqrt(var), floor).  The
// plain PyTorch version is src/repro_torch/kernels/tree_predict/ref.py.
//
// Bound on the H100: latency.  At the Lynceus shapes (M = 384 points,
// F = 5, B = 10 trees of depth 4) the call moves about 11 KB and does
// about 0.1 M operations: well under a microsecond of HBM or fp32 time,
// so a launch is a few thread blocks whose cost is the serial descent.
// The forest (B·D·W features and thresholds, B·2^D leaves, ~3 KB) goes to
// shared memory once per block; each thread gathers its point's feature
// values (`x[p, feat]`) directly.  The TPU kernel's one-hot feature matmul
// existed only because the TPU cannot gather.
//
// Variance: two passes (the mean first, then the sum of squared
// deviations; the second pass descends the trees again rather than hold B
// predictions in registers).  The TPU kernel's one-pass E[p²] - mu²
// cancels when |mu| >> sigma, which is where a forest's trees agree; the
// plain version's two-pass std does not, so the kernel follows it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float predict(const int* feat, const float* thr,
                                         const float* leaf, const float* x,
                                         int b, int D, int W, int L) {
  int pos = 0;
  for (int lvl = 0; lvl < D; ++lvl) {
    const int node = (b * D + lvl) * W + pos % W;
    const float t = thr[node];
    const bool right = x[feat[node]] > t && !isinf(t);
    pos = 2 * pos + (right ? 1 : 0);
  }
  return leaf[b * L + pos];
}

__global__ void __launch_bounds__(kThreads)
tree_predict_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                    const float* __restrict__ thr,
                    const float* __restrict__ leaf, float sigma_floor, int M,
                    int F, int B, int D, int W, int L, float* __restrict__ mu,
                    float* __restrict__ sigma) {
  extern __shared__ float smem[];
  const int nodes = B * D * W;
  int* s_feat = reinterpret_cast<int*>(smem);
  float* s_thr = smem + nodes;
  float* s_leaf = s_thr + nodes;
  for (int i = threadIdx.x; i < nodes; i += kThreads) {
    s_feat[i] = feat[i];
    s_thr[i] = thr[i];
  }
  for (int i = threadIdx.x; i < B * L; i += kThreads) s_leaf[i] = leaf[i];
  __syncthreads();

  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const float* xm = x + static_cast<size_t>(m) * F;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b)
    acc = acc + predict(s_feat, s_thr, s_leaf, xm, b, D, W, L);
  const float mean = acc / static_cast<float>(B);
  float acc2 = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float d = predict(s_feat, s_thr, s_leaf, xm, b, D, W, L) - mean;
    acc2 = acc2 + d * d;
  }
  mu[m] = mean;
  sigma[m] = fmaxf(sqrtf(acc2 / static_cast<float>(B)), sigma_floor);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  x [M, F] f32; feat [B, D, W] i32; thr [B, D, W] f32;
// leaf [B, L] f32; mu, sigma [M] f32, all contiguous on the card.
extern "C" int tree_predict_launch(const float* x, const int* feat,
                                   const float* thr, const float* leaf,
                                   float sigma_floor, int M, int F, int B,
                                   int D, int W, int L, float* mu,
                                   float* sigma, void* stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(B) * D * W
                                       + static_cast<size_t>(B) * L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (M > 0) {
    const int blocks = (M + kThreads - 1) / kThreads;
    tree_predict_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        x, feat, thr, leaf, sigma_floor, M, F, B, D, W, L, mu, sigma);
  }
  return static_cast<int>(cudaGetLastError());
}

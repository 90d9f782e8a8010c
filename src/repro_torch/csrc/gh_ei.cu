// Fused constrained EI, budget filter and Gauss-Hermite cost nodes for
// Hopper (sm_90a), one thread per candidate configuration.
//
// Replaces the TPU kernel `gh_ei_call` / `_kernel` of
// src/repro/kernels/gh_ei/kernel.py (pallas_call at line 70).  Per point:
//   sig   = max(sigma, 1e-12)
//   EI    = max((y* - mu)·Phi(z) + sig·phi(z), 0),  z = (y* - mu)/sig
//   eic   = EI · Phi((t_max·u - mu)/sig)
//   ok    = (beta - mu)/sig >= Phi^-1(conf)       (z-space budget filter)
//   nodes[k] = mu + (sqrt2·sig)·xi[k]
// with Phi(z) = 0.5·(1 + erf(z/sqrt2)) and phi(z) = exp(-z²/2)/sqrt(2pi),
// the library erf/exp as in the TPU kernel (not the fenced polynomials of
// core/acquisition).  The plain PyTorch version is
// src/repro_torch/kernels/gh_ei/ref.py.
//
// Bound on the H100: latency.  At M = 384 points and K = 3 nodes the call
// moves about 9 KB and does some 30 K operations; one launch of a few
// blocks.  y*, t_max and beta come from a float32 device array, so a call
// needs no host round trip.
//
// `ok` equals the plain version's exactly: the same float32 operations
// (IEEE division under -prec-div=true, -ftz=true as the plain version
// flushes) against the float32 quantile the host passes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// float32 of the TPU kernel's constants.
constexpr float kInvSqrt2 = 0x1.6a09e6p-1f;      // 1/sqrt(2)
constexpr float kInvSqrt2Pi = 0x1.988454p-2f;    // 1/sqrt(2pi)
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kSigEps = 0x1.197998p-40f;       // 1e-12

__device__ __forceinline__ float Phi(float z) {
  return 0.5f * (1.0f + erff(z * kInvSqrt2));
}

__device__ __forceinline__ float phi(float z) {
  return kInvSqrt2Pi * expf((-0.5f * z) * z);
}

__global__ void __launch_bounds__(kThreads)
gh_ei_kernel(const float* __restrict__ mu, const float* __restrict__ sigma,
             const float* __restrict__ u, const float* __restrict__ scal,
             const float* __restrict__ xi, float conf_q, int M, int K,
             float* __restrict__ eic, uint8_t* __restrict__ ok,
             float* __restrict__ nodes) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const float y_star = scal[0], t_max = scal[1], beta = scal[2];
  const float mu_m = mu[m];
  const float sig = fmaxf(sigma[m], kSigEps);
  const float d = y_star - mu_m;
  const float z = d / sig;
  const float ei = fmaxf(d * Phi(z) + sig * phi(z), 0.0f);
  const float p_time = Phi((t_max * u[m] - mu_m) / sig);
  eic[m] = ei * p_time;
  ok[m] = (beta - mu_m) / sig >= conf_q ? 1 : 0;
  const float step = kSqrt2 * sig;
  for (int k = 0; k < K; ++k)
    nodes[static_cast<size_t>(k) * M + m] = mu_m + step * xi[k];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// mu, sigma, u [M] f32; scal [3] f32 = (y*, t_max, beta); xi [K] f32;
// eic [M] f32, ok [M] bool, nodes [K, M] f32, all on the card.
extern "C" int gh_ei_launch(const float* mu, const float* sigma,
                            const float* u, const float* scal,
                            const float* xi, float conf_q, int M, int K,
                            float* eic, uint8_t* ok, float* nodes,
                            void* stream) {
  if (M > 0) {
    const int blocks = (M + kThreads - 1) / kThreads;
    gh_ei_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        mu, sigma, u, scal, xi, conf_q, M, K, eic, ok, nodes);
  }
  return static_cast<int>(cudaGetLastError());
}

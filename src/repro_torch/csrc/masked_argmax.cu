// Masked, quantized argmax over one score row for Hopper (sm_90a): the
// selection step of the determinism gate's kernel fixture.
//
// Replaces the TPU kernel `_pallas_argmax` / `kernel` of
// src/repro/analysis/fixtures.py (pallas_call at line 101):
//   out[0] = argmax(quantize_scores(where(valid, score, -inf)))
// with quantize_scores' 12 mantissa bits, or, with quantize = 0 (the
// fixture's broken twin), the argmax of the raw masked scores.  The plain
// PyTorch version is src/repro_torch/kernels/masked_argmax/ref.py.
//
// argmax semantics are jnp.argmax's, which torch.argmax on the CPU shares:
// a NaN counts as the maximum and the first NaN wins; an exact tie goes to
// the lowest index (-0.0 ties +0.0, and scores that quantizing makes equal
// tie); when every lane is invalid (all -inf) the result is 0.
// Quantizing is bit arithmetic on the uint32 view, exactly as
// acquisition.quantize_scores does it: (bits + 2^10) & ~(2^11 - 1), with
// NaN passed through.
//
// Bound on the H100: bytes.  The call reads 5·M bytes (score f32, valid
// bool) and writes 4; at M = 16 that is a launch's latency, at M = 1 << 20
// about 1.6 us of HBM time.  The design is the simple one: one block of
// 1024 threads loops over M with coalesced loads, each thread keeps its
// best (value, index) pair, and the pairs are combined by warp shuffles
// and then across the 32 warps in shared memory.  The combine is exact
// and order-independent (a total order on (value, index)), so the result
// does not depend on how lanes are assigned to threads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 12;

__device__ __forceinline__ float quantize(float x) {
  const uint32_t half = 1u << (22 - kBits);
  const uint32_t mask = 0xFFFFFFFFu << (23 - kBits);
  const uint32_t q = (__float_as_uint(x) + half) & mask;
  return x != x ? x : __uint_as_float(q);
}

// (a, ia) beats (b, ib): NaN beats every number, a larger value beats a
// smaller one, and an exact tie (including -0.0 == +0.0) goes to the
// lower index.  Among NaNs the lower index wins.
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
masked_argmax_kernel(const float* __restrict__ score,
                     const uint8_t* __restrict__ valid, int M, int quant,
                     int32_t* __restrict__ out) {
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int tid = threadIdx.x;
  float best = -INFINITY;
  int best_i = M;                      // sentinel: loses every real lane
  for (int m = tid; m < M; m += kThreads) {
    float v = valid[m] != 0 ? score[m] : -INFINITY;
    if (quant) v = quantize(v);
    if (better(v, m, best, best_i)) {
      best = v;
      best_i = m;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  if ((tid & 31) == 0) {
    red_v[tid >> 5] = best;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid != 0) return;
  best = red_v[0];
  best_i = red_i[0];
  for (int w = 1; w < kWarps; ++w) {
    if (better(red_v[w], red_i[w], best, best_i)) {
      best = red_v[w];
      best_i = red_i[w];
    }
  }
  out[0] = best_i < M ? best_i : 0;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// score [M] f32, valid [M] bool, out [1] int32, all on the card.
extern "C" int masked_argmax_launch(const float* score, const uint8_t* valid,
                                    int M, int quant, int32_t* out,
                                    void* stream) {
  masked_argmax_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      score, valid, M, quant, out);
  return static_cast<int>(cudaGetLastError());
}

// Masked, quantized argmax over one score row for Hopper (sm_90a): the
// selection step of the determinism gate's kernel fixture.
//
// Replaces the TPU kernel `_pallas_argmax` / `kernel` of
// src/repro/analysis/fixtures.py (pallas_call at line 101):
//   out[0] = argmax(quantize_scores(where(valid, score, -inf)))
// with quantize_scores' 12 mantissa bits, or, with quantize = 0 (the
// fixture's broken twin), the argmax of the raw masked scores.  The plain
// PyTorch version is src/repro_torch/kernels/masked_argmax/ref.py, and
// `argmax_keys` there is the plain form of this kernel's key.
//
// argmax semantics are jnp.argmax's, which torch.argmax on the CPU shares:
// a NaN counts as the maximum and the first NaN wins; an exact tie goes to
// the lowest index (-0.0 ties +0.0, and scores that quantizing makes equal
// tie); when every lane is invalid (all -inf) the result is 0.
// Quantizing is bit arithmetic on the uint32 view, exactly as
// acquisition.quantize_scores does it: (bits + 2^10) & ~(2^11 - 1), with
// NaN passed through.
//
// Every lane becomes one 64-bit key whose maximum is that answer: the high
// word is the value's bits in a monotone unsigned order (NaN above +inf,
// -0.0 on +0.0's word), the low word 0xFFFFFFFF - index (a lower index
// wins a tie).  A maximum does not depend on the order it is taken in, so
// the result does not depend on the grid, the tiling or the schedule.
//
// Bound on the H100: bytes.  The call reads 5·M bytes (score f32, valid
// bool) and writes 4; at M = 16 that is a launch's latency, at M = 1 << 20
// about 1.6 us of HBM time.  Design: one launch whatever M is.  Each
// thread reads a float4 of scores and a 4-byte word of valid flags at a
// time (scalar loads for an unaligned row and the tail), keeps its best
// key, and the block combines keys by warp shuffles and one warp.  A small
// row (the wrapper's `plan`) takes one block of as few warps as it needs
// and writes the answer itself.  A large one takes about two blocks an SM:
// each block writes its key to its slot of the scratch, and the last block
// to finish (an atomic ticket after a fence) combines the slots, writes
// the answer and resets the ticket to 0 for the next launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kBits = 12;

typedef unsigned long long Key;

__device__ __forceinline__ float quantize(float x) {
  const uint32_t half = 1u << (22 - kBits);
  const uint32_t mask = 0xFFFFFFFFu << (23 - kBits);
  const uint32_t q = (__float_as_uint(x) + half) & mask;
  return x != x ? x : __uint_as_float(q);
}

// The lane's key: see the note at the top.  0 is below every lane's key
// (the least high word of a lane, -inf's, is 0x007FFFFF).
__device__ __forceinline__ Key lane_key(float score, bool valid,
                                             int quant, uint32_t m) {
  float v = valid ? score : -INFINITY;
  if (quant) v = quantize(v);
  uint32_t hi;
  if (v != v) {
    hi = 0xFFFFFFFFu;
  } else {
    const uint32_t b = v == 0.0f ? 0u : __float_as_uint(v);
    hi = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  return (static_cast<Key>(hi) << 32) | (0xFFFFFFFFu - m);
}

__device__ __forceinline__ Key kmax(Key a, Key b) {
  return a > b ? a : b;
}

// The block's maximum key, valid in thread 0.
__device__ __forceinline__ Key block_max(Key key, Key* red) {
  for (int o = 16; o > 0; o >>= 1)
    key = kmax(key, __shfl_xor_sync(0xffffffffu, key, o));
  const int warps = blockDim.x >> 5;
  if (warps == 1) return key;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = key;
  __syncthreads();
  if (warp == 0) {
    key = lane < warps ? red[lane] : 0;
    for (int o = 16; o > 0; o >>= 1)
      key = kmax(key, __shfl_xor_sync(0xffffffffu, key, o));
  }
  return key;
}

__device__ __forceinline__ int32_t index_of(Key key) {
  return key == 0 ? 0
                  : static_cast<int32_t>(0xFFFFFFFFu
                                         - static_cast<uint32_t>(key));
}

__global__ void __launch_bounds__(kMaxThreads)
masked_argmax_kernel(const float* __restrict__ score,
                     const uint8_t* __restrict__ valid, int M, int quant,
                     Key* __restrict__ slots,
                     unsigned int* __restrict__ ticket,
                     int32_t* __restrict__ out) {
  __shared__ Key red[kMaxThreads / 32];
  __shared__ bool last;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  Key best = 0;
  // Four lanes a load where the row is aligned for it; then the tail (or
  // the whole of an unaligned row) a lane at a time.
  const bool vec = (reinterpret_cast<uintptr_t>(score) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(valid) & 3) == 0;
  const int quads = vec ? M >> 2 : 0;
  const float4* score4 = reinterpret_cast<const float4*>(score);
  const uint32_t* valid4 = reinterpret_cast<const uint32_t*>(valid);
  for (int g = first; g < quads; g += 2 * stride) {
    // Two quads in flight a thread: both loads issue before either key.
    const int h = g + stride;
    const float4 s0 = __ldg(score4 + g);
    const uint32_t v0 = __ldg(valid4 + g);
    float4 s1 = make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t v1 = 0;
    if (h < quads) {
      s1 = __ldg(score4 + h);
      v1 = __ldg(valid4 + h);
    }
    const uint32_t m0 = 4u * static_cast<uint32_t>(g);
    best = kmax(best, lane_key(s0.x, v0 & 0xFFu, quant, m0));
    best = kmax(best, lane_key(s0.y, (v0 >> 8) & 0xFFu, quant, m0 + 1));
    best = kmax(best, lane_key(s0.z, (v0 >> 16) & 0xFFu, quant, m0 + 2));
    best = kmax(best, lane_key(s0.w, v0 >> 24, quant, m0 + 3));
    if (h < quads) {
      const uint32_t m1 = 4u * static_cast<uint32_t>(h);
      best = kmax(best, lane_key(s1.x, v1 & 0xFFu, quant, m1));
      best = kmax(best, lane_key(s1.y, (v1 >> 8) & 0xFFu, quant, m1 + 1));
      best = kmax(best, lane_key(s1.z, (v1 >> 16) & 0xFFu, quant, m1 + 2));
      best = kmax(best, lane_key(s1.w, v1 >> 24, quant, m1 + 3));
    }
  }
  for (int m = 4 * quads + first; m < M; m += stride)
    best = kmax(best, lane_key(__ldg(score + m), __ldg(valid + m) != 0,
                               quant, static_cast<uint32_t>(m)));
  best = block_max(best, red);

  if (gridDim.x == 1) {
    if (threadIdx.x == 0) out[0] = index_of(best);
    return;
  }
  if (threadIdx.x == 0) {
    slots[blockIdx.x] = best;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every other block's slot is written and fenced.
  Key key = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += blockDim.x)
    key = kmax(key, __ldcg(slots + b));
  __syncthreads();              // `red` is reused
  key = block_max(key, red);
  if (threadIdx.x == 0) {
    out[0] = index_of(key);
    *ticket = 0u;
  }
}

}  // namespace

// (registers a thread, local bytes) of the kernel, as the loaded module
// reports them.
extern "C" int masked_argmax_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, masked_argmax_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

// Launches `grid` blocks of `threads` threads (kernel.py's `plan`) on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a geometry the kernel does not take.
// score [M] f32, valid [M] bool, out [1] int32; with grid > 1, slots
// [grid] uint64 and the ticket, a uint32 that is 0 between launches (the
// wrapper's scratch for the stream), all on the card.
extern "C" int masked_argmax_launch(const float* score, const uint8_t* valid,
                                    int M, int quant, int grid, int threads,
                                    Key* slots, unsigned int* ticket,
                                    int32_t* out, void* stream) {
  if (grid < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      (grid > 1 && (slots == nullptr || ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  masked_argmax_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      score, valid, M, quant, slots, ticket, out);
  return static_cast<int>(cudaGetLastError());
}

// Decode attention for Hopper (sm_90a): one query token per head against
// a ring KV cache, with an optional sliding window.
//
// Replaces the TPU kernel `decode_attention_call` / `_kernel` of
// src/repro/kernels/decode_attention/kernel.py (pallas_call at line 88).
// q [B, H, D] (contiguous) and k, v [B, KH, T, D] (float32 or bfloat16;
// each row of D values contiguous, rows at the strides the caller gives,
// so a [B, T, KH, D] cache goes in as its transposed view) give o
// [B, H, D] in q's type.  Slot i of the ring holds absolute position
// pos - ((pos - i) mod T) with floor modulo; a slot is live if that
// position is in [0, pos] and, with a window, > pos - window.  Dead slots
// score -0.7·FLT_MAX, as in the TPU kernel.  The write position `pos` is
// read on the card (an int32 device scalar) or passed by value, so a call
// never waits on the host.  The plain PyTorch version is
// src/repro_torch/kernels/decode_attention/ref.py.
//
// Bound on the H100: bytes.  The whole cache is read once per token: at
// gemma2-9b's widths (KH = 8, D = 256) and B = 8, T = 8192 in bf16 that is
// about 0.54 GB against 4·B·H·T·D ≈ 0.27 GFLOP.
//
// Design: one block of 256 threads per (batch, KV head), walking all T
// slots in tiles of 64 (as the TPU grid does); the G = H / KH query heads
// that share the KV head ride along as one [G, D] tile in shared memory,
// so K and V are read from device memory exactly once.  Per tile: every
// thread issues vector loads of the K and V tiles into shared memory, one
// warp per key computes the G scores (lanes split D, shuffle reduction),
// one warp per head updates its running max and sum, and each thread
// accumulates its share of the G·D outputs (at most 16 each) in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kMaxOut = 16;   // outputs a thread holds: G·D <= 4096
constexpr float kNeg = -0.7f * 3.40282347e+38f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 fa = __bfloat1622float2(a);
  const float2 fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// n consecutive elements (a multiple of 4) of `src` into `dst` as float32.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int n) {
#pragma unroll 4
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
    *reinterpret_cast<float4*>(dst + i) = load4(src + i);
}

// `rows` rows of D values (D a multiple of 4), row r at src + r·stride,
// into `dst` [rows][D] as float32.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           int rows, int D,
                                           long long stride) {
#pragma unroll 4
  for (int i = 4 * threadIdx.x; i < rows * D; i += 4 * kThreads)
    *reinterpret_cast<float4*>(dst + i) = load4(src + (i / D) * stride
                                                + i % D);
}

struct Params {
  int H, KH, T, D, window;   // window <= 0: none
  float scale;
  const int* pos_ptr;        // null: use pos_val
  int pos_val;
  long long sb, sh, st;      // K/V strides of batch, KV head and slot
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Params p) {
  extern __shared__ float smem[];
  const int G = p.H / p.KH;
  const int D = p.D;
  float* qs = smem;                       // [G][D]
  float* ks = qs + G * D;                 // [kTile][D]
  float* vs = ks + kTile * D;             // [kTile][D]
  float* ps = vs + kTile * D;             // [G][kTile]: scores, then p
  float* m_s = ps + G * kTile;            // [G] running max
  float* l_s = m_s + G;                   // [G] running sum
  float* a_s = l_s + G;                   // [G] this tile's rescale

  const int bkv = blockIdx.x;             // batch·KH + kv head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pos = p.pos_ptr != nullptr ? *p.pos_ptr : p.pos_val;
  // The G query heads of this KV head are contiguous in q and o.
  const size_t qo_off = static_cast<size_t>(bkv) * G * D;
  const long long kv_off = (bkv / p.KH) * p.sb + (bkv % p.KH) * p.sh;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  stage(qs, q + qo_off, G * D);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.0f;
  }
  const int n_out = G * D;
  float acc[kMaxOut];
#pragma unroll
  for (int e = 0; e < kMaxOut; ++e) acc[e] = 0.0f;

  for (int t0 = 0; t0 < p.T; t0 += kTile) {
    const int rows = min(kTile, p.T - t0);
    __syncthreads();                      // the previous tile is consumed
    stage_rows(ks, kb + t0 * p.st, rows, D, p.st);
    stage_rows(vs, vb + t0 * p.st, rows, D, p.st);
    __syncthreads();

    // Scores: one warp per key, lanes over D in float4 steps.
    for (int t = warp; t < kTile; t += kWarps) {
      const int slot = t0 + t;
      float live_s = -INFINITY;            // slots past T do not exist
      bool live = false;
      if (t < rows) {
        int r = (pos - slot) % p.T;        // floor modulo
        if (r < 0) r += p.T;
        const int kpos = pos - r;
        live = kpos >= 0 && kpos <= pos
               && (p.window <= 0 || kpos > pos - p.window);
        live_s = kNeg;
      }
      for (int g = 0; g < G; ++g) {
        float part = 0.0f;
        if (t < rows) {
          for (int d = 4 * lane; d < D; d += 128) {
            const float4 a = load4(qs + g * D + d);
            const float4 b = load4(ks + t * D + d);
            part = fmaf(a.x, b.x, part);
            part = fmaf(a.y, b.y, part);
            part = fmaf(a.z, b.z, part);
            part = fmaf(a.w, b.w, part);
          }
        }
#pragma unroll
        for (int o_ = 16; o_ > 0; o_ >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o_);
        if (lane == 0) ps[g * kTile + t] = live ? part * p.scale : live_s;
      }
    }
    __syncthreads();

    // Online softmax: one warp per head, two keys per lane.
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = ps[g * kTile + lane];
      const float s1 = ps[g * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o_);
      ps[g * kTile + lane] = p0;
      ps[g * kTile + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + p·V for this thread's outputs e = tid + 256·i.
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int e = threadIdx.x + kThreads * i;
      if (e < n_out) {
        const int g = e / D, d = e % D;
        const float* pg = ps + g * kTile;
        float pv = 0.0f;
        for (int t = 0; t < rows; ++t) pv = fmaf(pg[t], vs[t * D + d], pv);
        acc[i] = acc[i] * a_s[g] + pv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int e = threadIdx.x + kThreads * i;
    if (e < n_out) {
      const int g = e / D;
      store1(o + qo_off + e, acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Params& p, cudaStream_t stream) {
  const int G = p.H / p.KH;
  const size_t smem = sizeof(float) * (static_cast<size_t>(G) * p.D
                                       + 2 * static_cast<size_t>(kTile) * p.D
                                       + static_cast<size_t>(G) * kTile
                                       + 3 * static_cast<size_t>(G));
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B * p.KH > 0) {
    decode_kernel<T><<<B * p.KH, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take
// (D not a multiple of 4, H not a multiple of KH, G·D > 4096, T < 1).
// bf16 != 0: the tensors are bfloat16, else float32.  pos_ptr: an int32 on
// the card, or null to use pos_val.  window <= 0 means no window.
// s_batch, s_head and s_slot are the element strides of K and V (the same
// for both) over batch, KV head and slot; each a multiple of 4 (the rows
// are read as 16- or 8-byte vectors): s_slot = D and s_head = T·D for a
// contiguous cache.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* o, int bf16,
                                       int B, int H, int KH, int T, int D,
                                       float scale, int window,
                                       const int* pos_ptr, int pos_val,
                                       long long s_batch, long long s_head,
                                       long long s_slot, void* stream) {
  if (D <= 0 || D % 4 != 0 || KH <= 0 || H % KH != 0 || T < 1
      || (H / KH) * D > kThreads * kMaxOut || s_batch < 0 || s_head < 0
      || s_slot < 0 || s_batch % 4 != 0 || s_head % 4 != 0
      || s_slot % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{H,     KH,      T,       D,      window, scale,
                 pos_ptr, pos_val, s_batch, s_head, s_slot};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, B, p, st)
              : launch<float>(q, k, v, o, B, p, st);
}

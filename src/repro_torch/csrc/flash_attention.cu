// Flash attention for Hopper (sm_90a): causal / sliding-window /
// softcapped grouped-query attention with an online softmax in float32.
//
// Replaces the TPU kernel `flash_attention_call` / `_kernel` of
// src/repro/kernels/flash_attention/kernel.py (pallas_call at line 111).
// q [B, H, S, D] and k, v [B, KH, T, D] (float32 or bfloat16, contiguous)
// give o [B, H, S, D] in q's type.  Query head h reads KV head
// h / (H / KH) (the TPU kernel's `kv_map`); repeated K/V never exists in
// memory.  Per score: s = scale·q·k, then softcap·tanh(s / softcap), then
// the mask (key <= query if causal, key > query - window if windowed)
// sets masked scores to -0.7·FLT_MAX, as the TPU kernel does: a row's
// running max starts there, so a first tile in which a row has no live key
// contributes p = 1 per key until a live score rescales it to 0.
// o = acc / max(l, 1e-30).  The plain PyTorch version is
// src/repro_torch/kernels/flash_attention/ref.py.
//
// Bound on the H100: operations.  A gemma2-9b prefill (H = 16, KH = 8,
// D = 256, S = T = 8192, causal) needs some 5.5e11 multiply-adds of the
// two products against 0.2-0.4 GB of q, k, v and o.  This first kernel
// computes in float32 on the CUDA cores (explicit fmaf: the build keeps
// -fmad=false), without tensor cores, TMA or pipelining: bf16 inputs are
// widened to float32 in shared memory.
//
// Design: one block of 256 threads per (batch·head, 64-row query tile),
// heaviest causal tiles first.  The query tile stays in shared memory; for
// each 64-key tile the K tile is staged, each thread computes a 4 x 4
// block of scores (rows ty + 16i, keys tx + 16j) from float4 reads, the
// row max and sum go through 16-lane shuffles, the probabilities go to
// shared memory, the V tile replaces the K tile, and each thread
// accumulates 4 rows x D/16 output columns in registers.  Key tiles that
// the causal or window mask removes entirely are skipped.  D is padded to
// a multiple of 64 (DP) with zeros in shared memory: 64, 128, 192 or 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;   // query rows and keys of a tile
constexpr int kBQ = kTile;
constexpr int kBK = kTile;
constexpr int kPStride = kBK + 4;
constexpr float kNeg = -0.7f * 3.40282347e+38f;

struct Params {
  int H, KH, S, T, D;
  float scale, softcap;
  int causal, window;   // window <= 0: none
  int use_softcap;
};

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

// A tile: rows x D of `src` (row stride D) into `dst` ([kTile][DP + 4]),
// zero outside [0, rows) x [0, D).  D is a multiple of 4.
template <int DP, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows,
                                      int D) {
  constexpr int kVec = DP / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, d = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && d < D) val = load4(src + static_cast<size_t>(r) * D + d);
    *reinterpret_cast<float4*>(dst + r * (DP + 4) + d) = val;
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Params p) {
  constexpr int kStride = DP + 4;
  constexpr int kCols = DP / 64;           // float4 output columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][kStride]
  float* kvs = qs + kBQ * kStride;         // [kBK][kStride]: K, then V
  float* ps = kvs + kBK * kStride;         // [kBQ][kPStride]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = b * p.KH + h / (p.H / p.KH);
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int q0 = qi * kBQ;
  const int q_rows = min(kBQ, p.S - q0);
  const int first_q = q0, last_q = q0 + q_rows - 1;

  const T* qb = q + (static_cast<size_t>(bh) * p.S + q0) * p.D;
  const T* kb = k + static_cast<size_t>(kvh) * p.T * p.D;
  const T* vb = v + static_cast<size_t>(kvh) * p.T * p.D;
  stage<DP>(qs, qb, q_rows, p.D);

  float acc[4][kCols][4];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNeg;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;
  }

  const int n_kv = (p.T + kBK - 1) / kBK;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBK;
    // Tiles that the mask removes for every row of this query tile.
    if (p.causal && k0 > last_q) break;
    if (p.window > 0 && k0 + kBK - 1 <= first_q - p.window) continue;
    const int k_rows = min(kBK, p.T - k0);
    __syncthreads();                       // previous V tile consumed
    stage<DP>(kvs, kb + static_cast<size_t>(k0) * p.D, k_rows, p.D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = load4(qs + (ty + 16 * i) * kStride + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = load4(kvs + (tx + 16 * c) * kStride + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = s[i][c];
          a = fmaf(qv[i].x, kv[c].x, a);
          a = fmaf(qv[i].y, kv[c].y, a);
          a = fmaf(qv[i].z, kv[c].z, a);
          a = fmaf(qv[i].w, kv[c].w, a);
          s[i][c] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        float x = s[i][c] * p.scale;
        if (p.use_softcap) x = p.softcap * tanhf(x / p.softcap);
        bool live = true;
        if (p.causal) live = live && kp <= qp;
        if (p.window > 0) live = live && kp > qp - p.window;
        // Keys past T (a ragged last tile) do not exist: -inf, p = 0.
        x = kp >= p.T ? -INFINITY : (live ? x : kNeg);
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = expf(s[i][c] - m_new);
        ps[(ty + 16 * i) * kPStride + tx + 16 * c] = pr;
        sum += pr;
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o_);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();                       // scores done with the K tile
    stage<DP>(kvs, vb + static_cast<size_t>(k0) * p.D, k_rows, p.D);
    __syncthreads();

    for (int t = 0; t < kBK; t += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = load4(ps + (ty + 16 * i) * kPStride + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float4 vv =
              load4(kvs + (t + u) * kStride + 4 * (tx + 16 * c));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pr = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                           : u == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(pr, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pr, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pr, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pr, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

  T* ob = o + (static_cast<size_t>(bh) * p.S + q0) * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + 16 * c) + e;
        if (d < p.D) store1(ob + static_cast<size_t>(r) * p.D + d,
                            acc[i][c][e] / denom);
      }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kBQ + kBK) * (DP + 4)
                                       + kBQ * kPStride);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<DP, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S + kBQ - 1) / kBQ, B * p.H);
  if (grid.x > 0 && grid.y > 0) {
    flash_kernel<DP, T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dp(const void* q, const void* k, const void* v, void* o, int B,
                const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<64, T>(q, k, v, o, B, p, stream);
  if (p.D <= 128) return launch<128, T>(q, k, v, o, B, p, stream);
  if (p.D <= 192) return launch<192, T>(q, k, v, o, B, p, stream);
  return launch<256, T>(q, k, v, o, B, p, stream);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take
// (D > 256 or not a multiple of 4, H not a multiple of KH).  bf16 != 0:
// the tensors are bfloat16, else float32.  window <= 0 means no window;
// use_softcap == 0 means no softcap.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bf16,
                                      int B, int H, int KH, int S, int T,
                                      int D, float scale, int causal,
                                      int window, int use_softcap,
                                      float softcap, void* stream) {
  if (D <= 0 || D > 256 || D % 4 != 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{H, KH, S, T, D, scale, softcap, causal, window, use_softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_dp<__nv_bfloat16>(q, k, v, o, B, p, st)
              : dispatch_dp<float>(q, k, v, o, B, p, st);
}

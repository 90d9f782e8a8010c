// Decode attention for Hopper (sm_90a): one query token per head against
// a ring KV cache, with an optional sliding window and an optional softcap
// (Gemma2's), split over the cache (flash-decoding).
//
// Replaces the TPU kernel `decode_attention_call` / `_kernel` of
// src/repro/kernels/decode_attention/kernel.py (pallas_call at line 88).
// q [B, H, D] (contiguous) and k, v [B, KH, T, D] (float32 or bfloat16;
// each row of D values contiguous, rows at the strides the caller gives,
// so a [B, T, KH, D] cache goes in as its transposed view) give o
// [B, H, D] in q's type.  Slot i of the ring holds absolute position
// pos - ((pos - i) mod T) with floor modulo; a slot is live if that
// position is in [0, pos] and, with a window, > pos - window.  A live
// slot scores s = scale·q·k, then softcap·tanh(s / softcap) with a softcap
// (tanhf, no fast math), as the JAX model's `_scores` does
// (src/repro/models/attention.py); the TPU kernel takes no softcap, and
// the JAX model decodes Gemma2 outside it.  Dead slots score -0.7·FLT_MAX,
// as in the TPU kernel; slots past T do not exist.
// The write position `pos` is read on the card (an int32 device scalar)
// or passed by value, so a call never waits on the host.  The plain
// PyTorch version is src/repro_torch/kernels/decode_attention/ref.py.
//
// Bound on the H100: bytes.  The whole cache is read once per token: at
// gemma2-9b's widths (KH = 8, D = 256) and B = 8, T = 8192 in bf16 that
// is 0.54 GB, 0.160 ms at 3.35 TB/s, against 4·B·H·T·D = 0.27 GFLOP; at
// zamba2-7b's (B = 4, KH = 32, G = 1, D = 112, T = 1032, f32) 0.035 ms.
//
// Design: a call is two kernels.
// 1. `decode_split_kernel`, grid (B·KH, n_split): block (b·KH + kv head,
//    split) walks the split's whole 64-slot tiles (the split plan is
//    `split_plan` in kernels/decode_attention/kernel.py: at least two
//    waves of blocks on the card's SMs, no empty split, chosen from T
//    alone).  The G = H / KH query heads of the KV head ride along as one
//    [G, D] float32 tile in shared memory, so K and V are read from device
//    memory once.  K and V tiles stay in their storage type in shared
//    memory, in a 3-stage ring of 32-slot tiles filled by `cp.async`
//    copies (32 slots rather than 64 so that two blocks fit on an SM at
//    gemma2-9b's widths, 105 KB each): the next two tiles' loads are in
//    flight while this tile's scores and P·V run, and the one barrier
//    after a tile lands also frees the stage the next copy refills.  Per
//    tile: each warp computes the G scores of 4 keys side by side (lanes
//    split D, shuffle reductions interleaved), one warp per head updates
//    its running max and sum, and each thread accumulates vectors of 4 of
//    the G·D outputs in registers (at most 4 vectors; where the outputs
//    are fewer than 4 a thread, groups of threads split the tile's slots
//    and are merged in group order at the end).  The block writes its
//    split's (m [G], l [G], acc [G, D]) in float32 to the scratch the
//    wrapper allocated.
// 2. `decode_combine_kernel`, one block per (b, kv head): in fixed split
//    order, m = max m_i, o = Σ acc_i·e^(m_i - m) / max(Σ l_i·e^(m_i - m),
//    1e-30), so the result is the same on every run (no atomics).  A split
//    whose slots are all dead keeps m_i = -0.7·FLT_MAX and weighs 0 against
//    a live one; when every slot is dead every split weighs 1 and o is the
//    mean of V over the T slots, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPlanTile = 64;   // slots of a split-plan tile
constexpr int kTile = 32;       // slots of a shared-memory tile
constexpr int kStages = 3;      // depth of the K/V ring
constexpr int kMaxOut = 16;     // outputs a thread holds: G·D <= 4096
constexpr int kMaxVec = kMaxOut / 4;
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

// VEC (4 or 8) consecutive values as float32.
template <int VEC>
__device__ __forceinline__ void loadv(const float* p, float (&x)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; i += 4) {
    const float4 v = load4(p + i);
    x[i] = v.x;
    x[i + 1] = v.y;
    x[i + 2] = v.z;
    x[i + 3] = v.w;
  }
}

template <int VEC>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p,
                                      float (&x)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    const float4 v = load4(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
}

// One lane's share of the dot products q_g·k_t for the PER keys t = warp
// + 8u of a tile: lanes over D, VEC values a lane a step.
template <int VEC, int PER, typename T>
__device__ __forceinline__ void dot_keys(float (&sc)[PER], const float* qg,
                                         const T* kt, int D, int rows,
                                         int warp, int lane) {
  for (int d = VEC * lane; d < D; d += 32 * VEC) {
    float a[VEC];
    loadv<VEC>(qg + d, a);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int t = warp + kWarps * u;
      if (t < rows) {
        float b[VEC];
        loadv<VEC>(kt + t * D + d, b);
#pragma unroll
        for (int e = 0; e < VEC; ++e) sc[u] = fmaf(a[e], b[e], sc[u]);
      }
    }
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool vec16) {
  if (vec16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// `rows` rows of D values (row r at src + r·stride) into dst [rows][D], in
// the storage type, by 16-byte copies (8-byte when a row is not a whole
// number of 16 bytes).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows,
                                          int D, long long stride,
                                          bool vec16) {
  const int ch = (vec16 ? 16 : 8) / static_cast<int>(sizeof(T));
  const int per_row = D / ch;
  // Copy i = threadIdx.x + kThreads·n is (row r, chunk c): stepped, not
  // divided, per copy.
  const int dr = kThreads / per_row, dc = kThreads % per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
  while (r < rows) {
    cp_async(smem_u32(dst + r * D + c * ch), src + r * stride + c * ch,
             vec16);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

struct Params {
  int H, KH, T, D, window;   // window <= 0: none
  float scale, softcap;
  int use_softcap;           // 0: no softcap
  const int* pos_ptr;        // null: use pos_val
  int pos_val;
  long long sb, sh, st;      // K/V strides of batch, KV head and slot
  int tiles_per_split;       // 64-slot tiles of a split
  int vec16;                 // K/V rows and strides allow 16-byte copies
};

// One split of one (batch, KV head).  Two blocks an SM: at most 128
// registers a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part,
                    Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = p.H / p.KH;
  const int D = p.D;
  const int tile_elems = kTile * D;
  T* ks = reinterpret_cast<T*>(smem_raw);          // [kStages][kTile][D]
  T* vs = ks + kStages * tile_elems;               // [kStages][kTile][D]
  float* qs = reinterpret_cast<float*>(vs + kStages * tile_elems);  // [G][D]
  float* red = qs + G * D;                // [kThreads·4]: group merge
  float* ps = red + 4 * kThreads;         // [G][kTile]: scores, then p
  float* m_s = ps + G * kTile;            // [G] running max
  float* l_s = m_s + G;                   // [G] running sum
  float* a_s = l_s + G;                   // [G] this tile's rescale

  const int bkv = blockIdx.x;             // batch·KH + kv head
  const int split = blockIdx.y, n_split = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pos = p.pos_ptr != nullptr ? *p.pos_ptr : p.pos_val;
  // The G query heads of this KV head are contiguous in q and o.
  const size_t qo_off = static_cast<size_t>(bkv) * G * D;
  const long long kv_off = (bkv / p.KH) * p.sb + (bkv % p.KH) * p.sh;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;
  const int s_begin = split * p.tiles_per_split * kPlanTile;
  const int s_end = min(p.T, s_begin + p.tiles_per_split * kPlanTile);
  const int n_tiles = (s_end - s_begin + kTile - 1) / kTile;

  auto issue = [&](int i) {               // tile i of the split, if any
    if (i < n_tiles) {
      const int t0 = s_begin + i * kTile;
      const int rows = min(kTile, s_end - t0);
      const int stage = i % kStages;
      copy_rows(ks + stage * tile_elems, kb + t0 * p.st, rows, D, p.st,
                p.vec16);
      copy_rows(vs + stage * tile_elems, vb + t0 * p.st, rows, D, p.st,
                p.vec16);
    }
    cp_async_commit();                    // an empty group keeps the count
  };
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  for (int i = threadIdx.x; i < G * D / 4; i += kThreads)
    reinterpret_cast<float4*>(qs)[i] = load4(q + qo_off + 4 * i);
  for (int g = threadIdx.x; g < G; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.0f;
  }
  // P·V in vectors of 4 outputs (one head's d..d+3).  With fewer vectors
  // than threads, n_grp groups of threads take the tile's slots t = grp
  // mod n_grp, merged in group order when the split ends.
  const int n_out = G * D, n_vec = n_out / 4;
  const int n_grp = n_vec >= kThreads ? 1 : kThreads / n_vec;
  const int grp = n_vec >= kThreads ? 0 : threadIdx.x / n_vec;
  float4 acc[kMaxVec];
#pragma unroll
  for (int j = 0; j < kMaxVec; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int tid = threadIdx.x;
  auto vec_of = [&](int j) -> int {       // this thread's j-th vector
    if (n_vec >= kThreads) return tid + kThreads * j;
    return j == 0 && grp < n_grp ? tid % n_vec : n_vec;
  };

  for (int i = 0; i < n_tiles; ++i) {
    // Tile i has landed once at most kStages - 2 newer groups are pending.
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile i visible; tile i - 1 and its p consumed
    issue(i + kStages - 1);
    const int t0 = s_begin + i * kTile;
    const int rows = min(kTile, s_end - t0);
    const T* kt = ks + (i % kStages) * tile_elems;
    const T* vt = vs + (i % kStages) * tile_elems;

    // Scores: warp w takes keys w, w + 8, ...; the kTile / 8 dot products
    // of a head run side by side (lanes over D), then reduce.
    constexpr int kPer = kTile / kWarps;
    float dead[kPer];
    bool live[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int t = warp + kWarps * u, slot = t0 + t;
      live[u] = false;
      dead[u] = -INFINITY;                 // slots past T do not exist
      if (t < rows) {
        int r = (pos - slot) % p.T;        // floor modulo
        if (r < 0) r += p.T;
        const int kpos = pos - r;
        live[u] = kpos >= 0 && kpos <= pos
                  && (p.window <= 0 || kpos > pos - p.window);
        dead[u] = kNeg;
      }
    }
    for (int g = 0; g < G; ++g) {
      float sc[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) sc[u] = 0.0f;
      // 16-byte rows of K: 8 bf16 values a lane where D allows.
      if (sizeof(T) == 2 && D % 8 == 0)
        dot_keys<8>(sc, qs + g * D, kt, D, rows, warp, lane);
      else
        dot_keys<4>(sc, qs + g * D, kt, D, rows, warp, lane);
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1)
#pragma unroll
        for (int u = 0; u < kPer; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o_);
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          float x = sc[u] * p.scale;
          if (p.use_softcap) x = p.softcap * tanhf(x / p.softcap);
          ps[g * kTile + warp + kWarps * u] = live[u] ? x : dead[u];
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per head, kTile / 32 keys a lane.
    for (int g = warp; g < G; g += kWarps) {
      float sc[kTile / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        sc[u] = ps[g * kTile + lane + 32 * u];
        mx = fmaxf(mx, sc[u]);
      }
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < kTile / 32; ++u) {
        const float pr = expf(sc[u] - m_new);
        ps[g * kTile + lane + 32 * u] = pr;
        sum += pr;
      }
#pragma unroll
      for (int o_ = 16; o_ > 0; o_ >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o_);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = fmaf(l_s[g], alpha, sum);
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + p·V for this thread's vectors.
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const int vi = vec_of(j);
      if (vi < n_vec) {
        const int g = 4 * vi / D, d = 4 * vi % D;
        const float* pg = ps + g * kTile;
        const float alpha = a_s[g];
        float4 a = make_float4(acc[j].x * alpha, acc[j].y * alpha,
                               acc[j].z * alpha, acc[j].w * alpha);
#pragma unroll 4
        for (int t = grp; t < rows; t += n_grp) {
          const float pt = pg[t];
          const float4 vv = load4(vt + t * D + d);
          a.x = fmaf(pt, vv.x, a.x);
          a.y = fmaf(pt, vv.y, a.y);
          a.z = fmaf(pt, vv.z, a.z);
          a.w = fmaf(pt, vv.w, a.w);
        }
        acc[j] = a;
      }
    }
  }
  cp_async_wait<0>();

  // This split's partials: acc [G][D], then m [G] and l [G].
  const size_t slot = static_cast<size_t>(bkv) * n_split + split;
  float4* pacc = reinterpret_cast<float4*>(part + slot * n_out);
  if (n_grp > 1) {
    if (grp < n_grp)
      reinterpret_cast<float4*>(red)[threadIdx.x] = acc[0];
    __syncthreads();
    if (grp == 0) {
      float4 sum = reinterpret_cast<float4*>(red)[threadIdx.x];
      for (int k2 = 1; k2 < n_grp; ++k2) {
        const float4 x = reinterpret_cast<float4*>(red)[threadIdx.x
                                                        + k2 * n_vec];
        sum = make_float4(sum.x + x.x, sum.y + x.y, sum.z + x.z,
                          sum.w + x.w);
      }
      pacc[threadIdx.x] = sum;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kMaxVec; ++j) {
      const int vi = vec_of(j);
      if (vi < n_vec) pacc[vi] = acc[j];
    }
  }
  float* pml = part + static_cast<size_t>(gridDim.x) * n_split * n_out
               + slot * 2 * G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    pml[2 * g] = m_s[g];
    pml[2 * g + 1] = l_s[g];
  }
}

// The splits of one (batch, KV head) into its G·D outputs, in split order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                      int G, int D, int n_split) {
  const int bkv = blockIdx.x;
  const int n_out = G * D;
  const float* pacc = part + static_cast<size_t>(bkv) * n_split * n_out;
  const float* pml = part + static_cast<size_t>(gridDim.x) * n_split * n_out
                     + static_cast<size_t>(bkv) * n_split * 2 * G;
  for (int e = threadIdx.x; e < n_out; e += kThreads) {
    const int g = e / D;
    float m = kNeg;
    for (int i = 0; i < n_split; ++i) m = fmaxf(m, pml[i * 2 * G + 2 * g]);
    float num = 0.0f, den = 0.0f;
    for (int i = 0; i < n_split; ++i) {
      const float w = expf(pml[i * 2 * G + 2 * g] - m);
      num = fmaf(pacc[static_cast<size_t>(i) * n_out + e], w, num);
      den = fmaf(pml[i * 2 * G + 2 * g + 1], w, den);
    }
    store1(o + static_cast<size_t>(bkv) * n_out + e, num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           float* part, int B, int n_split, const Params& p,
           cudaStream_t stream) {
  if (B * p.KH == 0) return static_cast<int>(cudaGetLastError());
  const int G = p.H / p.KH;
  // At most 219 KB (f32, D = 256, G·D = 4096); 105 KB in bf16 at
  // gemma2-9b's widths, two blocks an SM.
  const size_t smem = sizeof(T) * 2 * kStages * kTile * p.D
                      + sizeof(float) * (static_cast<size_t>(G) * p.D
                                         + 4 * kThreads
                                         + static_cast<size_t>(G) * kTile
                                         + 3 * G);
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_split_kernel<T><<<dim3(B * p.KH, n_split), kThreads, smem,
                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<T><<<B * p.KH, kThreads, 0, stream>>>(
      part, static_cast<T*>(o), G, p.D, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the split kernel and then the combine kernel on `stream`;
// returns cudaGetLastError() after each (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take (D not a
// multiple of 4, H not a multiple of KH, G·D > 4096, T < 1, strides not
// multiples of 4, a split plan that leaves a split empty).  bf16 != 0: the
// tensors are bfloat16, else float32.  pos_ptr: an int32 on the card, or
// null to use pos_val.  window <= 0 means no window; use_softcap == 0 no
// softcap.  s_batch, s_head and
// s_slot are the element strides of K and V (the same for both) over
// batch, KV head and slot: s_slot = D and s_head = T·D for a contiguous
// cache.  `part` is float32 scratch of B·KH·n_split·G·(D + 2) values; each
// split covers tiles_per_split 64-slot tiles.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* o, void* part,
                                       int bf16, int B, int H, int KH, int T,
                                       int D, float scale, int window,
                                       int use_softcap, float softcap,
                                       const int* pos_ptr, int pos_val,
                                       long long s_batch, long long s_head,
                                       long long s_slot, int n_split,
                                       int tiles_per_split, void* stream) {
  const int n_tiles = (T + kPlanTile - 1) / kPlanTile;
  if (D <= 0 || D % 4 != 0 || KH <= 0 || H % KH != 0 || T < 1
      || (H / KH) * D > kThreads * kMaxOut || s_batch < 0 || s_head < 0
      || s_slot < 0 || s_batch % 4 != 0 || s_head % 4 != 0
      || s_slot % 4 != 0 || n_split < 1 || tiles_per_split < 1
      || (n_split - 1) * tiles_per_split >= n_tiles
      || n_split * tiles_per_split < n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = bf16 ? 2 : 4;
  // 16-byte copies need every row start 16-byte aligned.
  const int vec16 = (static_cast<long long>(D) * esize) % 16 == 0
                    && (s_batch * esize) % 16 == 0
                    && (s_head * esize) % 16 == 0
                    && (s_slot * esize) % 16 == 0;
  const Params p{H,       KH,          T,       D,       window,
                 scale,   softcap,     use_softcap,       pos_ptr,
                 pos_val, s_batch,     s_head,  s_slot,  tiles_per_split,
                 vec16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, o, pt, B, n_split, p, st)
              : launch<float>(q, k, v, o, pt, B, n_split, p, st);
}

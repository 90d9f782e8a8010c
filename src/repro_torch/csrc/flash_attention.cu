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
// contributes p = 1 per key until a live score rescales it to 0.  Keys
// past T score -inf.  o = acc / max(l, 1e-30).  Given a non-null `lse`
// [B, H, S] (float32 only), the kernel also writes each row's
// log-sum-exp m + log(max(l, 1e-30)), which the backward kernel
// (flash_attention_bwd.cu) reads to recompute P; serving passes null and
// its launches and numbers are as before.  The plain PyTorch version is
// src/repro_torch/kernels/flash_attention/ref.py.
//
// Bound on the H100: operations.  A gemma2-9b prefill (H = 16, KH = 8,
// D = 256, S = T = 8192, causal) needs 4·D·H·(live pairs) = 5.5e11 FLOP
// of the two products against 0.2-0.4 GB of q, k, v and o: 0.556 ms at
// the bf16 tensor-core peak (989 TFLOP/s), 8.2 ms at float32's 67.
// Two kernels, chosen by the input type:
//
// float32 (`flash_kernel`): on the CUDA cores (explicit fmaf: the build
// keeps -fmad=false), since TF32 would break the float32 contract.  One
// block of 256 threads per (batch·head, 64-row query tile), heaviest
// causal tiles first.  The query tile stays in shared memory; for each
// 64-key tile the K tile is staged, each thread computes a 4 x 4 block of
// scores (rows ty + 16i, keys tx + 16j) from float4 reads, the row max
// and sum go through 16-lane shuffles, the probabilities go to shared
// memory, the V tile replaces the K tile, and each thread accumulates 4
// rows x D/16 output columns in registers.  Key tiles that the causal or
// window mask removes entirely are skipped.  D is padded to a multiple of
// 64 (DP) with zeros in shared memory: 64, 128, 192 or 256.
//
// bfloat16 (`flash_bf16_kernel`): FlashAttention-2's forward on the
// tensor cores.  One block of 8 warps per (batch·head, 128-row query
// tile), heaviest causal tiles first; each warp owns 16 query rows and
// walks 64-key tiles, 48-key at D > 224 (8 warps rather than 4: at one
// block an SM, 4 warps left each scheduler one warp and nothing to hide
// its latency with).
// Q, K and V stay bf16 in shared memory, rows padded by 16 bytes so that
// the 8 row addresses of an `ldmatrix` fall in 8 different bank groups;
// D is zero-padded to a multiple of 32 (DP).  At D = 256: Q 66 KB, K and
// V in a two-stage ring 99 KB, 165 KB of the 227.  K and V come in by
// `cp.async` 16-byte copies (8-byte where D is not a multiple of 8): tile
// j+1 is in flight while tile j is in the products; rows past S or T and
// columns past D are zero-filled by the copy itself.  S = Q·Kᵀ is
// `mma.sync.m16n8k16` bf16 x bf16 into float32 (a bf16 product is exact
// in float32); Q is read from shared memory by `ldmatrix` per k-step
// rather than held in registers.  The scale, softcap and mask act on the S
// fragments; the row max and sum reduce over the 4 lanes of a fragment
// row (shuffles 1 and 2); l sums the float32 p.  P·V takes p packed
// straight from the S accumulator fragments into A fragments (no trip
// through shared memory), with V by `ldmatrix.trans`, in two bf16 parts,
// head and remainder, two products on one V fragment: p rounded once to
// bf16 put rows with few live keys one bf16 ulp of p·v off, outside the
// bf16 tolerance.  A warp holds its O accumulator in registers, D/8 x 4
// float32 a thread (128 at D = 256), and S 32 more; -Xptxas -v shows no
// spill at any DP.  The output goes out through the Q tile's shared rows
// in 16-byte stores.  What is left of the bound is `wgmma` with TMA and
// warp specialisation.

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

// A tile: rows x D of `src` (row stride D) into `dst` ([kTile][DP + 4]),
// zero outside [0, rows) x [0, D).  D is a multiple of 4.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int rows, int D) {
  constexpr int kVec = DP / 4;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec, d = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && d < D) val = load4(src + static_cast<size_t>(r) * D + d);
    *reinterpret_cast<float4*>(dst + r * (DP + 4) + d) = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, Params p) {
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

  const float* qb = q + (static_cast<size_t>(bh) * p.S + q0) * p.D;
  const float* kb = k + static_cast<size_t>(kvh) * p.T * p.D;
  const float* vb = v + static_cast<size_t>(kvh) * p.T * p.D;
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

  float* ob = o + (static_cast<size_t>(bh) * p.S + q0) * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * p.S + q0 + r] = m_run[i] + logf(denom);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (tx + 16 * c) + e;
        if (d < p.D)
          ob[static_cast<size_t>(r) * p.D + d] = acc[i][c][e] / denom;
      }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kBQ + kBK) * (DP + 4)
                                       + kBQ * kPStride);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S + kBQ - 1) / kBQ, B * p.H);
  if (grid.x > 0 && grid.y > 0) {
    flash_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), p);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dp(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, const Params& p, cudaStream_t stream) {
  if (p.D <= 64) return launch<64>(q, k, v, o, lse, B, p, stream);
  if (p.D <= 128) return launch<128>(q, k, v, o, lse, B, p, stream);
  if (p.D <= 192) return launch<192>(q, k, v, o, lse, B, p, stream);
  return launch<256>(q, k, v, o, lse, B, p, stream);
}


// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores.
// ---------------------------------------------------------------------------
constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;   // query rows of a block
// Keys of a tile: 64, but 48 at DP = 256, where a 64-key tile's S and P
// fragments beside the O accumulator spill past 255 registers a thread.
constexpr int kTcKeys = 64;
constexpr int kTcKeys256 = 48;
constexpr int kTcStages = 2;             // K/V ring depth

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous copy of 16 (vec16) or 8 bytes; `valid` 0 zero-fills.
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool vec16, bool valid) {
  if (vec16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 8 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a·b for a 16 x 16 bf16 A fragment, a 16 x 8 bf16 B fragment and a
// 16 x 8 float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// (x0, x1) as two bf16 pairs whose sum carries 16 bits of each: hi is the
// rounded value, lo the rounded remainder (x - hi is exact in float32).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// `rows` rows of D bf16 values (row stride D) into a shared tile of ROWS
// rows at DP + 8 values a row, zero where r >= rows or the column >= D.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int D, bool vec16) {
  const int ch = vec16 ? 8 : 4;          // values a copy
  const int per_row = DP / ch;
  for (int i = threadIdx.x; i < ROWS * per_row; i += kTcThreads) {
    const int r = i / per_row, c = (i % per_row) * ch;
    const bool ok = r < rows && c < D;
    cp_async(smem_u32(dst + r * (DP + 8) + c),
             ok ? src + static_cast<size_t>(r) * D + c : src, vec16, ok);
  }
}

template <int DP, int KEYS>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, Params p, int vec16) {
  constexpr int kStride = DP + 8;        // bf16 a shared row
  constexpr int kNB = DP / 8;            // 8-column blocks of O
  constexpr int kTile = KEYS * kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTcRows * kStride;   // [kTcStages][keys][kStride]
  __nv_bfloat16* vs = ks + kTcStages * kTile;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = b * p.KH + h / (p.H / p.KH);
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int q0 = qi * kTcRows;
  const int q_rows = min(kTcRows, p.S - q0);
  const int first_q = q0, last_q = q0 + q_rows - 1;
  // This thread's two rows of every fragment: r_lo and r_lo + 8.
  const int r_lo = warp * 16 + lane / 4;
  const int qp[2] = {q0 + r_lo, q0 + r_lo + 8};

  const __nv_bfloat16* qb = q + (static_cast<size_t>(bh) * p.S + q0) * p.D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(kvh) * p.T * p.D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(kvh) * p.T * p.D;

  // The key tiles that some row of this query tile can see.
  const int n_kv = (p.T + KEYS - 1) / KEYS;
  const int j_end = p.causal ? min(n_kv, last_q / KEYS + 1) : n_kv;
  int j_begin = 0;
  if (p.window > 0) {
    const int x = first_q - p.window - (KEYS - 1);
    if (x >= 0) j_begin = x / KEYS + 1;
  }
  auto load_kv = [&](int j, int stage) {
    const int k0 = j * KEYS;
    const int rows = min(KEYS, p.T - k0);
    load_tile<DP, KEYS>(ks + stage * kTile, kb + static_cast<size_t>(k0)
                        * p.D, rows, p.D, vec16);
    load_tile<DP, KEYS>(vs + stage * kTile, vb + static_cast<size_t>(k0)
                        * p.D, rows, p.D, vec16);
  };
  load_tile<DP, kTcRows>(qs, qb, q_rows, p.D, vec16);
  if (j_begin < j_end) load_kv(j_begin, 0);
  cp_async_commit();

  float acc[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.0f, 0.0f};

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8.
  const int mat = lane / 8, mrow = lane % 8;
  const uint32_t q_addr = smem_u32(qs + (warp * 16 + lane % 16) * kStride
                                   + (lane / 16) * 8);
  // K (B of Q·Kᵀ, non-transposed): matrices (keys 0-7 | 8-15) x (d 0-7 |
  // 8-15) give the b0b1 / b2b3 pairs of two 8-key blocks.
  const int k_off = (mrow + (mat / 2) * 8) * kStride + (mat % 2) * 8;
  // V (B of P·V, transposed): matrices (keys 0-7 | 8-15) x (d 0-7 | 8-15)
  // give the pairs of two 8-column blocks.
  const int v_off = (mrow + (mat % 2) * 8) * kStride + (mat / 2) * 8;

  for (int j = j_begin; j < j_end; ++j) {
    const int stage = (j - j_begin) % kTcStages;
    if (j + 1 < j_end) load_kv(j + 1, (stage + 1) % kTcStages);
    cp_async_commit();
    cp_async_wait<1>();                  // tile j (and Q) have landed
    __syncthreads();

    // S = Q·Kᵀ: 16 rows x KEYS keys a warp, in blocks of 8 keys.
    constexpr int kNS = KEYS / 8;
    float s[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const uint32_t k_base = smem_u32(ks + stage * kTile + k_off);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(q_addr + kk * 32, a);
#pragma unroll
      for (int n2 = 0; n2 < KEYS / 16; ++n2) {
        uint32_t bk[4];
        ldsm_x4(k_base + (n2 * 16 * kStride + kk * 16) * 2, bk);
        mma_bf16(s[2 * n2], a, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }

    // Scale, softcap, mask; element e of block n is row qp[e / 2], key
    // k0 + 8n + 2·quad + e % 2.
    const int k0 = j * KEYS;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + 2 * quad + (e % 2);
        const int row = qp[e / 2];
        float x = s[n][e] * p.scale;
        if (p.use_softcap) x = p.softcap * tanhf(x / p.softcap);
        bool live = true;
        if (p.causal) live = live && kp <= row;
        if (p.window > 0) live = live && kp > row - p.window;
        x = kp >= p.T ? -INFINITY : (live ? x : kNeg);
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f}, m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_new[e / 2]);
        sum[e / 2] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_run[r] = fmaf(l_run[r], alpha[r], sum[r]);
    }
    // The max of a warp's rows moves in few tiles: skip the rescale when
    // every alpha of the warp is 1.
    if (!__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) {
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e / 2];
    }

    // O += P·V: P's A fragments are the S accumulators of two key blocks,
    // each split into a bf16 head and a bf16 remainder (two products, one
    // V fragment).
    const uint32_t v_base = smem_u32(vs + stage * kTile + v_off);
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int n2 = 0; n2 < DP / 16; ++n2) {
        uint32_t bv[4];
        ldsm_x4_trans(v_base + (kk * 16 * kStride + n2 * 16) * 2, bv);
        mma_bf16(acc[2 * n2], ah, bv[0], bv[1]);
        mma_bf16(acc[2 * n2], al, bv[0], bv[1]);
        mma_bf16(acc[2 * n2 + 1], ah, bv[2], bv[3]);
        mma_bf16(acc[2 * n2 + 1], al, bv[2], bv[3]);
      }
    }
    __syncthreads();                     // this stage is free to refill
  }
  cp_async_wait<0>();
  __syncthreads();

  // o = acc / max(l, 1e-30) in bf16, through the Q tile's shared rows.
  const float denom[2] = {fmaxf(l_run[0], 1e-30f), fmaxf(l_run[1], 1e-30f)};
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(qs + (r_lo + 8 * r) * kStride + 8 * n
                                   + 2 * quad) =
          pack_bf16(acc[n][2 * r] / denom[r], acc[n][2 * r + 1] / denom[r]);
  __syncthreads();
  __nv_bfloat16* ob = o + (static_cast<size_t>(bh) * p.S + q0) * p.D;
  const int ch = vec16 ? 8 : 4;
  const int per_row = p.D / ch;
  for (int i = threadIdx.x; i < q_rows * per_row; i += kTcThreads) {
    const int r = i / per_row, c = (i % per_row) * ch;
    const __nv_bfloat16* src = qs + r * kStride + c;
    __nv_bfloat16* dst = ob + static_cast<size_t>(r) * p.D + c;
    if (vec16)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  }
}

template <int DP, int KEYS>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (DP + 8)
                      * (kTcRows + 2 * kTcStages * KEYS);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<DP, KEYS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S + kTcRows - 1) / kTcRows, B * p.H);
  if (grid.x > 0 && grid.y > 0) {
    flash_bf16_kernel<DP, KEYS><<<grid, kTcThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), p, p.D % 8 == 0);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int B, const Params& p, cudaStream_t stream) {
  switch ((p.D + 31) / 32) {
    case 1: return launch_bf16<32, kTcKeys>(q, k, v, o, B, p, stream);
    case 2: return launch_bf16<64, kTcKeys>(q, k, v, o, B, p, stream);
    case 3: return launch_bf16<96, kTcKeys>(q, k, v, o, B, p, stream);
    case 4: return launch_bf16<128, kTcKeys>(q, k, v, o, B, p, stream);
    case 5: return launch_bf16<160, kTcKeys>(q, k, v, o, B, p, stream);
    case 6: return launch_bf16<192, kTcKeys>(q, k, v, o, B, p, stream);
    case 7: return launch_bf16<224, kTcKeys>(q, k, v, o, B, p, stream);
    default: return launch_bf16<256, kTcKeys256>(q, k, v, o, B, p, stream);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take
// (D > 256 or not a multiple of 4, H not a multiple of KH; a non-null
// lse with bfloat16).  bf16 != 0: the tensors are bfloat16, else float32.
// window <= 0 means no window; use_softcap == 0 means no softcap.  lse
// null: no log-sum-exp output.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bf16,
                                      int B, int H, int KH, int S, int T,
                                      int D, float scale, int causal,
                                      int window, int use_softcap,
                                      float softcap, void* stream) {
  if (D <= 0 || D > 256 || D % 4 != 0 || KH <= 0 || H % KH != 0
      || (bf16 && lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{H, KH, S, T, D, scale, softcap, causal, window, use_softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bf16(q, k, v, o, B, p, st)
              : dispatch_dp(q, k, v, o, lse, B, p, st);
}

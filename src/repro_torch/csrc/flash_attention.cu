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
// the bf16 tensor-core peak (989 TFLOP/s), 8.2 ms at float32's 67 on the
// CUDA cores; float32 in split TF32 (three products each at 495 TFLOP/s)
// 3.3 ms.  Two kernels, chosen by the input type:
//
// float32 (`flash_tf32_kernel`): FlashAttention-2's forward on the tensor
// cores in split TF32, after csrc/flash_attention_bwd.cu.  Both products,
// S = Q·Kᵀ and O += P·V, are `mma.sync.m16n8k8` TF32 with each float32
// operand split into hi, its TF32 rounding (by integer arithmetic: cvt
// runs at a quarter of the ALU's rate), and lo = x - hi: hi·hi + hi·lo +
// lo·hi, about 2^-21 of each product against TF32's 2^-11, so the float32
// contract holds.  The tensor cores truncate their running sums, so a
// fragment sums one 64-column slab of D for S (two fragments in turn
// where a tile has fewer than 64 keys) and one key tile for P·V, and is
// then added into float32 sums by plain additions (P·V's folded into the
// rescale: acc = alpha·acc + part, one fmaf).  One block of NW warps per
// (batch·head, 16·NW-row query tile), heaviest causal tiles first; each
// warp owns 16 query rows and walks the key tiles that some row of the
// block can see (causal: up to the last row; window: from the first row's
// window), skipping, warp by warp, a tile whose keys all lie past its
// rows under causality.  K and V come in by `cp.async` 16-byte copies (D
// is a multiple of 4, so every float32 row is 16-byte aligned) into a
// two-stage ring that takes K_j, V_j, K_j+1, ... in turn: V_j lands while
// the warps take S of tile j, K_j+1 while they take P·V, and a tile is
// twice as long as a ring of (K, V) pairs would allow in the same bytes;
// rows past S or T and columns past D are zero-filled by the copy itself.
// Shared rows are padded by 4 floats (stride = 4 mod 32 banks), so every
// fragment load of Q, K and V hits 32 distinct banks.  P stays in
// registers: the k index of P·V is permuted (fragment slot t takes key 2t,
// slot t + 4 key 2t + 1, in A and B alike), so S's accumulator fragment
// (columns 2t, 2t + 1) is P's A fragment, split once a tile.  The scale,
// softcap and mask act on the S fragments; the row max and sum reduce
// over the 4 lanes of a fragment row (shuffles 1 and 2).  O is D/8 x 4
// float32 a thread in registers (128 at D = 256); the output is written
// from the fragments in float2 stores.  D is padded to a multiple of 64
// (DP) in shared memory; 8-column blocks past D are skipped.  The tiling
// (warps, keys, and whether Q is split once as it lands or at each
// fragment load) comes from kernel.fwd_plan, a function of the shapes
// alone; at DP 256, 8 warps and 32-key tiles: Q 133 KB and the ring 66.5
// KB, 200 KB of the 227 a block may have.  K and V are split at each
// fragment load: split as they land, their hi and lo would double the
// shared-memory reads of the B fragments, the largest stream, to save ALU
// work.  -Xptxas -v shows no spill at any DP (at most 245 registers).
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

constexpr float kNeg = -0.7f * 3.40282347e+38f;

struct Params {
  int H, KH, S, T, D;
  float scale, softcap;
  int causal, window;   // window <= 0: none
  int use_softcap;
};

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


// ---------------------------------------------------------------------------
// float32 on the tensor cores, in split TF32.
// ---------------------------------------------------------------------------

// x rounded to TF32 (to nearest, ties away from zero: the result of
// cvt.rna.tf32.f32) by integer arithmetic on its bits: cvt runs at a
// quarter of the ALU's rate on sm_90.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi its TF32 rounding, lo = x - hi (exact in float32, |lo|
// <= 2^-11 |x|), passed whole: the mma reads a TF32 operand by its upper
// 19 bits, so lo enters truncated, within 2^-21 of x.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[j] += a·b[j] in split TF32 (lo·hi, hi·lo, then hi·hi) for one A
// fragment (ah, al: its split) and J B fragments, b[j] the float32 pair
// (b0[j], b1[j]), split here; every b split first, then the three terms
// pass by pass, so that no two products in a row wait on one accumulator.
// Only j < jn (uniform over the block) take part.
template <int J>
__device__ __forceinline__ void mma3_tf32(float (&d)[J][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float (&b0)[J],
                                          const float (&b1)[J], int jn) {
  uint32_t bh[J][2], bl[J][2];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    split_tf32(b0[j], bh[j][0], bl[j][0]);
    split_tf32(b1[j], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < jn) mma_tf32(d[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < jn) mma_tf32(d[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j < jn) mma_tf32(d[j], ah, bh[j][0], bh[j][1]);
}

// `rows` rows of D float32 values (row stride D) into a shared tile of
// ROWS rows at DP + 4 values a row by 16-byte cp.async (D is a multiple of
// 4, so every row starts 16-byte aligned), zero where r >= rows or the
// column >= D.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              int rows, int D) {
  constexpr int kVec = DP / 4;
  for (int i = threadIdx.x; i < ROWS * kVec; i += THREADS) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const bool ok = r < rows && c < D;
    cp_async(smem_u32(dst + r * (DP + 4) + c),
             ok ? src + static_cast<size_t>(r) * D + c : src, true, ok);
  }
}

// S = Q·Kᵀ for the warp's 16 rows and the tile's KEYS keys into s (Q:
// float32 `qs`, or split `qh`, `ql` where SQ; `kt` at the lane's B
// element of key 0, column 0; `a_off`: the lane's A element of column
// 0), 64 keys at a time at DP <= 128 and 32 above (where O's registers
// leave no room for more).  A fragment sums one 64-column slab of D, then
// is added into the float32 scores.
template <int DP, int KEYS, bool SQ>
__device__ __forceinline__ void tile_scores(const float* qs,
                                            const uint32_t* qh,
                                            const uint32_t* ql,
                                            const float* kt, int a_off,
                                            int n8, float (&s)[KEYS / 8][4]) {
  constexpr int kStr = DP + 4;
  constexpr int kNS = KEYS / 8;
  constexpr int kGMax = DP <= 128 ? 8 : 4;
  constexpr int kG = kNS > kGMax ? kGMax : kNS;   // 8-key blocks a pass
  static_assert(kNS % kG == 0, "passes must cover the tile");
#pragma unroll
  for (int n0 = 0; n0 < kNS; n0 += kG) {
#pragma unroll
    for (int n = 0; n < kG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n0 + n][e] = 0.0f;
    for (int c0 = 0; c0 < n8; c0 += 8) {
      const int c1 = min(c0 + 8, n8);
      float part[kG][4];
#pragma unroll
      for (int n = 0; n < kG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll 2
      for (int c = c0; c < c1; ++c) {
        const int d = 8 * c;
        uint32_t ah[4], al[4];
        if constexpr (SQ) {
          const uint32_t* xh = qh + a_off + d;
          const uint32_t* xl = ql + a_off + d;
          ah[0] = xh[0]; ah[1] = xh[8 * kStr];
          ah[2] = xh[4]; ah[3] = xh[8 * kStr + 4];
          al[0] = xl[0]; al[1] = xl[8 * kStr];
          al[2] = xl[4]; al[3] = xl[8 * kStr + 4];
        } else {
          const float* x = qs + a_off + d;
          split_tf32(x[0], ah[0], al[0]);
          split_tf32(x[8 * kStr], ah[1], al[1]);
          split_tf32(x[4], ah[2], al[2]);
          split_tf32(x[8 * kStr + 4], ah[3], al[3]);
        }
        float b0[kG], b1[kG];
#pragma unroll
        for (int n = 0; n < kG; ++n) {
          b0[n] = kt[8 * (n0 + n) * kStr + d];
          b1[n] = kt[8 * (n0 + n) * kStr + d + 4];
        }
        mma3_tf32<kG>(part, ah, al, b0, b1, kG);
      }
#pragma unroll
      for (int n = 0; n < kG; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n0 + n][e] = s[n0 + n][e] + part[n][e];
    }
  }
}

// The online softmax on the score fragments, in place: scale, softcap,
// mask (element e of block n is row qp[e / 2], key k0 + 8n + 2t + e % 2),
// the row max and sum over the 4 lanes of a fragment row; s becomes P,
// alpha the rescale of the rows' running sums.
template <int KEYS>
__device__ __forceinline__ void tile_softmax(const Params& p, int k0, int t,
                                             const int (&qp)[2],
                                             float (&s)[KEYS / 8][4],
                                             float (&m_run)[2],
                                             float (&l_run)[2],
                                             float (&alpha)[2]) {
  constexpr int kNS = KEYS / 8;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kNS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = k0 + 8 * n + 2 * t + (e % 2);
      const int row = qp[e / 2];
      float x = s[n][e] * p.scale;
      if (p.use_softcap) x = p.softcap * tanhf(x / p.softcap);
      bool live = true;
      if (p.causal) live = live && kp <= row;
      if (p.window > 0) live = live && kp > row - p.window;
      // Keys past T (a ragged last tile) do not exist: -inf, p = 0.
      x = kp >= p.T ? -INFINITY : (live ? x : kNeg);
      s[n][e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  float sum[2] = {0.0f, 0.0f}, m_new[2];
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
    l_run[r] = l_run[r] * alpha[r] + sum[r];
  }
}

// O = alpha·O + P·V for the warp's 16 rows (`vt` at the lane's B element:
// key 2t, column g).  P's A fragment of key block n is S's accumulator
// fragment n with the k index permuted (slot t takes key 2t, slot t + 4
// key 2t + 1, in A and B alike): a0..a3 = s0, s2, s1, s3, split once.  KC
// blocks of O at a time (fewer where O's registers leave no room); a
// fragment sums the tile's keys and is then added into the float32 sums:
// acc = alpha·acc + part, one fmaf.
template <int DP, int KEYS, int KC>
__device__ __forceinline__ void tile_pv(const float* vt, int n8,
                                        const float (&s)[KEYS / 8][4],
                                        const float (&alpha)[2],
                                        float (&acc)[DP / 8][4]) {
  constexpr int kStr = DP + 4;
  constexpr int kNS = KEYS / 8;
  constexpr int kNB = DP / 8;
  constexpr int kC = KC;
  static_assert(kNB % kC == 0, "P·V passes must cover DP");
  uint32_t ph[kNS][4], pl[kNS][4];
#pragma unroll
  for (int n = 0; n < kNS; ++n) {
    split_tf32(s[n][0], ph[n][0], pl[n][0]);
    split_tf32(s[n][2], ph[n][1], pl[n][1]);
    split_tf32(s[n][1], ph[n][2], pl[n][2]);
    split_tf32(s[n][3], ph[n][3], pl[n][3]);
  }
#pragma unroll
  for (int c0 = 0; c0 < kNB; c0 += kC) {
    if (c0 < n8) {                       // uniform over the block
      float part[kC][4];
#pragma unroll
      for (int jj = 0; jj < kC; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[jj][e] = 0.0f;
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
        float b0[kC], b1[kC];
#pragma unroll
        for (int jj = 0; jj < kC; ++jj) {
          b0[jj] = vt[8 * n * kStr + 8 * (c0 + jj)];
          b1[jj] = vt[(8 * n + 1) * kStr + 8 * (c0 + jj)];
        }
        mma3_tf32<kC>(part, ph[n], pl[n], b0, b1, n8 - c0);
      }
#pragma unroll
      for (int jj = 0; jj < kC; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c0 + jj][e] = fmaf(acc[c0 + jj][e], alpha[e / 2],
                                 part[jj][e]);
    }
  }
}

// Shared memory of an instantiation: Q (twice where SQ) and the K/V ring
// of two stages, one K and one V tile, rows of DP + 4 floats.
template <int DP, int NW, int KEYS, bool SQ>
constexpr size_t f32_smem() {
  return sizeof(float) * (DP + 4) * ((SQ ? 2 : 1) * 16 * NW + 2 * KEYS);
}

// Two blocks an SM where two fit (4 warps, at most half the shared
// memory): 8 warps an SM either way.
template <int DP, int NW, int KEYS, bool SQ>
constexpr int f32_min_blocks() {
  return NW <= 4 && f32_smem<DP, NW, KEYS, SQ>() <= 232448 / 2 - 1024 ? 2
                                                                       : 1;
}

// One block of NW warps per (batch·head, 16·NW-row query tile); KEYS keys
// a K/V tile; SQ: Q split into hi and lo once, as it lands, else at each
// fragment load.  The ring's two stages take K_j, V_j, K_j+1, ... in
// turn: V_j is copied while every warp takes S of tile j, K_j+1 while it
// takes P·V, so each copy has half a tile's products to land in, and a
// tile is twice as long as two stages of (K, V) pairs would allow.
template <int DP, int NW, int KEYS, bool SQ>
__global__ void __launch_bounds__(32 * NW, (f32_min_blocks<DP, NW, KEYS,
                                                           SQ>()))
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, Params p) {
  constexpr int kThreadsF = 32 * NW;
  constexpr int kRows = 16 * NW;         // query rows of a block
  constexpr int kStr = DP + 4;           // floats a shared row
  constexpr int kNS = KEYS / 8;          // 8-key blocks of S
  constexpr int kNB = DP / 8;            // 8-column blocks of O
  // O blocks a P·V pass: 8 warps at DP >= 192 leave registers for 2.
  constexpr int kC = DP < 192 ? 8 : NW >= 8 ? 2 : 4;
  constexpr int kTileF = KEYS * kStr;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [kRows][kStr]
  uint32_t* qh = reinterpret_cast<uint32_t*>(qs);    // SQ: hi, then lo
  uint32_t* ql = qh + kRows * kStr;
  float* ks = qs + (SQ ? 2 : 1) * kRows * kStr;      // [KEYS][kStr]
  float* vs = ks + kTileF;                           // [KEYS][kStr]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = b * p.KH + h / (p.H / p.KH);
  const int qi = gridDim.x - 1 - blockIdx.x;   // heaviest causal first
  const int q0 = qi * kRows;
  const int q_rows = min(kRows, p.S - q0);
  const int first_q = q0, last_q = q0 + q_rows - 1;
  // This thread's two rows of every fragment: r_lo and r_lo + 8.
  const int r_lo = warp * 16 + g;
  const int qp[2] = {q0 + r_lo, q0 + r_lo + 8};
  const int warp_last = q0 + warp * 16 + 15;
  const int n8 = (p.D + 7) / 8;          // 8-column blocks holding D

  const float* qb = q + (static_cast<size_t>(bh) * p.S + q0) * p.D;
  const float* kb = k + static_cast<size_t>(kvh) * p.T * p.D;
  const float* vb = v + static_cast<size_t>(kvh) * p.T * p.D;

  // The key tiles that some row of this query tile can see.
  const int n_kv = (p.T + KEYS - 1) / KEYS;
  const int j_end = p.causal ? min(n_kv, last_q / KEYS + 1) : n_kv;
  int j_begin = 0;
  if (p.window > 0) {
    const int x = first_q - p.window - (KEYS - 1);
    if (x >= 0) j_begin = x / KEYS + 1;
  }
  auto load = [&](float* dst, const float* src, int j) {
    const int k0 = j * KEYS;
    load_rows_f32<KEYS, DP, kThreadsF>(
        dst, src + static_cast<size_t>(k0) * p.D, min(KEYS, p.T - k0), p.D);
  };
  load_rows_f32<kRows, DP, kThreadsF>(qs, qb, q_rows, p.D);
  cp_async_commit();                     // Q
  if (j_begin < j_end) load(ks, kb, j_begin);
  cp_async_commit();                     // the first K tile
  if constexpr (SQ) {
    cp_async_wait<1>();                  // Q has landed
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kStr; i += kThreadsF) {
      uint32_t hi, lo;
      split_tf32(qs[i], hi, lo);
      qh[i] = hi;
      ql[i] = lo;
    }
    __syncthreads();
  }

  float acc[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_run[2] = {kNeg, kNeg}, l_run[2] = {0.0f, 0.0f};

  // Fragment bases: A of S (Q rows r_lo, r_lo + 8, column t); B of S (key
  // g of each 8-key block, column t); B of P·V (keys 2t and 2t + 1,
  // column g).
  const int a_off = r_lo * kStr + t;
  const int k_off = g * kStr + t;
  const int v_off = 2 * t * kStr + g;

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * KEYS;
    // Causal: a warp whose rows all lie before the tile's first key takes
    // nothing from it (its rows have met a live key: alpha 1, p 0).
    const bool mine = !(p.causal && k0 > warp_last);
    cp_async_wait<0>();                  // K_j (and Q) have landed
    __syncthreads();                     // every warp is done with V_j-1
    load(vs, vb, j);                     // V_j, during S of tile j
    cp_async_commit();
    float s[kNS][4], alpha[2];
    if (mine) {
      tile_scores<DP, KEYS, SQ>(qs, qh, ql, ks + k_off, a_off, n8, s);
      tile_softmax<KEYS>(p, k0, t, qp, s, m_run, l_run, alpha);
    }
    cp_async_wait<0>();                  // V_j has landed
    __syncthreads();                     // every warp is done with K_j
    if (j + 1 < j_end) load(ks, kb, j + 1);   // K_j+1, during P·V
    cp_async_commit();
    if (mine) tile_pv<DP, KEYS, kC>(vs + v_off, n8, s, alpha, acc);
  }
  cp_async_wait<0>();                    // Q, if no tile was walked

  // o = acc / max(l, 1e-30), straight from the fragments (float2 stores:
  // D is a multiple of 4).
  float* ob = o + (static_cast<size_t>(bh) * p.S + q0) * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= q_rows) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(bh) * p.S + q0 + row] =
          m_run[r] + logf(denom);
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      const int d = 8 * n + 2 * t;
      if (d < p.D)
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(row) * p.D + d) =
            make_float2(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
    }
  }
}

template <int DP, int NW, int KEYS, bool SQ>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, const Params& p, cudaStream_t stream) {
  constexpr size_t smem = f32_smem<DP, NW, KEYS, SQ>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32_kernel<DP, NW, KEYS, SQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((p.S + 16 * NW - 1) / (16 * NW), B * p.H);
  if (grid.x > 0 && grid.y > 0) {
    flash_tf32_kernel<DP, NW, KEYS, SQ><<<grid, 32 * NW, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(lse), p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The instantiation that kernel.fwd_plan names (kernel.FWD_TILES): (warps,
// keys, split_q) at D padded to a multiple of 64; any other is refused.
int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, const Params& p, int warps, int keys,
                 int split_q, cudaStream_t stream) {
  const int dp = (p.D + 63) / 64 * 64;
  auto is = [&](int dp_, int nw, int ky, int sq) {
    return dp == dp_ && warps == nw && keys == ky && split_q == sq;
  };
#define FLASH_F32(DP_, NW_, KEYS_, SQ_)                                     \
  if (is(DP_, NW_, KEYS_, SQ_))                                             \
    return launch_f32<DP_, NW_, KEYS_, SQ_>(q, k, v, o, lse, B, p, stream);
  FLASH_F32(64, 8, 64, true)
  FLASH_F32(128, 8, 64, true)
  FLASH_F32(192, 4, 32, false)
  FLASH_F32(256, 8, 32, false)
#undef FLASH_F32
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take
// (D > 256 or not a multiple of 4, H not a multiple of KH; a non-null
// lse with bfloat16; a float32 plan (warps, keys, split_q) that is not
// instantiated).  bf16 != 0: the tensors are bfloat16, else float32.
// window <= 0 means no window; use_softcap == 0 means no softcap.  lse
// null: no log-sum-exp output.  warps, keys and split_q come from
// kernel.fwd_plan (float32 only; bfloat16 ignores them).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bf16,
                                      int B, int H, int KH, int S, int T,
                                      int D, float scale, int causal,
                                      int window, int use_softcap,
                                      float softcap, int warps, int keys,
                                      int split_q, void* stream) {
  if (D <= 0 || D > 256 || D % 4 != 0 || KH <= 0 || H % KH != 0
      || (bf16 && lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{H, KH, S, T, D, scale, softcap, causal, window, use_softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch_bf16(q, k, v, o, B, p, st)
              : dispatch_f32(q, k, v, o, lse, B, p, warps, keys, split_q,
                             st);
}

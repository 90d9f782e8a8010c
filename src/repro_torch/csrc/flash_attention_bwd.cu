// Flash-attention backward for Hopper (sm_90a): the gradients dq, dk, dv
// of csrc/flash_attention.cu's float32 forward, on the tensor cores in
// split TF32.
//
// Replaces no TPU kernel: the JAX package trains through plain jnp
// attention (src/repro/launch/train.py:49 picks attend's "naive" or
// "chunked" form) and none of its Pallas kernels has a VJP.  The port's
// forward on the card is the hand-written kernel, and a CUDA tensor may
// not fall back to autograd through the plain version, so its gradient is
// this kernel.  The contract is the forward's: causal and non-causal, a
// sliding window, Gemma2's softcap (derivative 1 - tanh^2), GQA and MQA,
// D a multiple of 4 up to 256, S and T off the tiles; float32 only
// (training runs float32).  The plain PyTorch version is
// ref.attention_bwd_ref in src/repro_torch/kernels/flash_attention/.
//
// Per (query, key) pair the kernels recompute the raw score s = q.k, and
// P = exp(x - lse) from the forward's log-sum-exp lse [B, H, S], x the
// scaled (and softcapped) score.  With dP = dO.v and delta = rowsum(dO*O):
//   dS = P (dP - delta), zero where the mask removes the pair, times
//   (1 - tanh^2) under the softcap;
//   dV = sum over query rows of P dO, dK = scale * sum of dS q, and
//   dQ = scale * sum over keys of dS k.
// A row with no live key at all (a window that closes before key 0 can
// open: rows at or past T + window - 1) is the softmax of a constant
// row: P = 1/T on every key, dS = 0.
//
// Four kernels a call, no atomics, so two runs give the same bits:
// 1. bwd_delta_kernel: delta, one warp a row (a fixed shuffle tree);
// 2. bwd_dkdv_kernel: one block of 8 warps per (split, batch x KV head,
//    32-key tile), grid (n_split, B x KH, T/32): key tile 0, the heaviest
//    under causality, launches first.  K and V stay in shared memory; the
//    block walks its split's H/KH/n_split query heads of the KV head's
//    group and every query tile that has a live pair with its keys (or a
//    dead row), in order.  n_split comes from bwd_plan in
//    kernels/flash_attention/kernel.py, a function of the shapes alone
//    (never of the card): one query head a block (n_split = H/KH), so
//    gemma-2b's MQA gets 512 blocks where one block a key tile gave 64
//    on 132 SMs, the first walking all 8 heads.  The kernel takes any
//    n_split that divides the group.  With one split (MHA) the block
//    writes dK and dV;
//    with several it writes its partials into the workspace
//    [2][n_split][B x KH][T][D], and
// 3. bwd_reduce_kernel sums them in ascending split order, one addition
//    at a time, and writes dK (times scale) and dV;
// 4. bwd_dq_kernel: one block per (batch x query head, 32-row query
//    tile), grid (B x H, S/32): the heaviest causal tiles of every head
//    launch first.  It walks the live key tiles.
//
// The five products (S = Q.K^T and dP = dO.V^T recomputed; dV += P^T.dO,
// dK += dS^T.Q, dQ += dS.K) are mma.sync.m16n8k8 TF32 with each float32
// operand split into hi, its TF32 rounding, and lo = x - hi, three
// products hi.hi + hi.lo + lo.hi into float32 fragments (the scheme of
// csrc/ssm_scan.cu): about 2^-21 of each product against TF32's 2^-11,
// so the float32 contract holds.  Operands are split in registers when a
// fragment is loaded (shared memory holds float32 only), hi by integer
// arithmetic (cvt runs at a quarter of the ALU rate: with it the split
// took 4x the tensor cores' time), lo read by the mma at its upper 19
// bits.  The tensor cores truncate their running sums, so a fragment
// sums one 32-row or 32-key tile (64 columns of D for S and dP) and is
// then added into float32 sums by plain additions: summed over whole
// rows in the fragments, gemma2-9b's dK came to 0.8 of the gate.
//
// A tile step is two phases between barriers.  Phase 1: warps 0-3 take
// S, warps 4-7 dP, a 16 x 16 block each over D; each warp hands the half
// of its block it does not finish to its partner (warp +- 4) through
// shared memory, so both apply the scale, softcap, mask, dead rows, P =
// exp(x - lse) and dS to one half, on the accumulator fragments in
// registers, and leave P and dS in shared memory once, as the next
// products' operands.  Phase 2 of dK/dV: warps 0-3 sum dV, warps 4-7 dK,
// each warp all 32 keys x D/4 columns (n-tiles 4j + warp % 4), D/64 x 8
// floats a thread (64 at D = 256); of dQ: every warp all 32 rows x D/8
// columns.  S recomputed on the tensor cores differs from the forward's
// fmaf chain in its last bits (P may pass 1 by an ulp), well inside the
// gate's 1e-4 of the largest gradient.
//
// Shared memory: rows padded by 4 floats (stride = 4 mod 32 banks), and
// the k index of the P^T.dO, dS^T.Q and dS.K products permuted (fragment
// slot t takes row 2t, slot t + 4 row 2t + 1, in A and B alike), so every
// fragment load hits 32 distinct banks.  The streamed tiles (Q and dO in
// the dK/dV pass, K and V in the dQ pass) arrive by cp.async 16-byte
// copies into a two-stage ring: after the barrier that opens tile i, tile
// i + 1 is issued into the other stage and lands while tile i is in the
// products; rows past S or T and columns past D are zero-filled by the
// copy.  At D = 256: the resident tile pair 65 KB, the ring 130 KB, P
// and dS 9 KB (dS 5 KB in the dQ pass): 205 KB (200 KB) of the 227 a
// block may have, one block an SM; at D <= 128 two blocks an SM.
// Columns past D (D padded to DP, a multiple of 64) are skipped a warp at
// a time.
//
// Bound on the H100: operations.  Five products of 2.D.H FLOP per live
// pair: gemma-2b's layer (H 8, D 256, S = T = 2048, causal) needs 43
// GFLOP, 0.64 ms at float32's 67 TFLOP/s on the CUDA cores; three TF32
// products each, 129 GFLOP, 0.26 ms at TF32's 495 TFLOP/s.
//
// Built with -fmad=false (products are contracted only where written as
// fmaf) and IEEE expf, tanhf, as the forward.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kBQ = 32;             // query rows of a tile
constexpr int kBK = 32;             // keys of a tile
constexpr int kPS = 36;             // P, dS of the dK/dV pass: [kBQ][kPS]
constexpr int kDS = 40;             // dS of the dQ pass: [kBQ][kDS]

struct Params {
  int H, KH, S, T, D;
  float scale, softcap;
  int causal, window;   // window <= 0: none
  int use_softcap;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a.b over the four lanes, x first.
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ---------------------------------------------------------------------------
// Copies
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ROWS x D of `src` (row stride D) into `dst` ([ROWS][DP + 4]) by 16-byte
// cp.async, zero-filled outside [0, rows) x [0, D).  D is a multiple of 4.
template <int ROWS, int DP>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int rows, int D) {
  constexpr int kVec = DP / 4;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, d = (i % kVec) * 4;
    const bool ok = r < rows && d < D;
    cp_async16(dst + r * (DP + 4) + d,
               ok ? src + static_cast<size_t>(r) * D + d : src,
               ok ? 16 : 0);
  }
}

// The tile's rows of lse and delta into lse_s, dl_s [kBQ], zero past n.
__device__ __forceinline__ void stage_rows(float* lse_s, float* dl_s,
                                           const float* lse,
                                           const float* delta, int n) {
  const int r = threadIdx.x;
  if (r < kBQ) {
    const bool ok = r < n;
    cp_async4(lse_s + r, ok ? lse + r : lse, ok ? 4 : 0);
    cp_async4(dl_s + r, ok ? delta + r : delta, ok ? 4 : 0);
  }
}

// ---------------------------------------------------------------------------
// Split TF32 (after csrc/ssm_scan.cu)
// ---------------------------------------------------------------------------
// x rounded to TF32 (to nearest, ties away from zero: the result of
// cvt.rna.tf32.f32) by integer arithmetic on its bits, at the ALU's full
// rate; cvt runs at a quarter of it on sm_90 and, two a split, bound the
// kernel.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi its TF32 rounding, lo the remainder x - hi (exact in
// float32, |lo| <= 2^-11 |x|), passed whole: the mma reads a TF32 operand
// by its upper 19 bits, so lo enters truncated, within 2^-21 of x.
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
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

// d[m][j] += a[m]·b[j] for M A fragments (ah, al: their splits) and J B
// fragments in split TF32, b[j] the float32 pair (b0[j], b1[j]): every b
// split first, then the three terms pass by pass (the two small ones
// first), so that no two products in a row wait on one accumulator.
// Only j < jn (warp-uniform) take part.
template <int M, int J>
__device__ __forceinline__ void mma3_tf32(float (&d)[M][J][4],
                                          const uint32_t (&ah)[M][4],
                                          const uint32_t (&al)[M][4],
                                          const float (&b0)[J],
                                          const float (&b1)[J], int jn) {
  uint32_t bh[J][2], bl[J][2];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    split_tf32(b0[j], bh[j][0], bl[j][0]);
    split_tf32(b1[j], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j < jn) mma_tf32(d[m][j], al[m], bh[j][0], bh[j][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j < jn) mma_tf32(d[m][j], ah[m], bl[j][0], bl[j][1]);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j < jn) mma_tf32(d[m][j], ah[m], bh[j][0], bh[j][1]);
}

// The A fragment at a (row-major, row stride STR), split: a0 = (g, t), a1
// = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4) relative to a, with
// `a` already at (g, t).
template <int STR>
__device__ __forceinline__ void load_a(const float* a, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  split_tf32(a[0], ah[0], al[0]);
  split_tf32(a[8 * STR], ah[1], al[1]);
  split_tf32(a[4], ah[2], al[2]);
  split_tf32(a[8 * STR + 4], ah[3], al[3]);
}

// Adds a tile's fragment sums into the running float32 sums, one float32
// addition each: the tensor cores truncate their running sum, which over
// thousands of products drifts (at gemma2-9b's shape dK to 0.8 of the
// gate); a fresh fragment a tile keeps that to a few dozen products.
template <int M, int J>
__device__ __forceinline__ void promote(float (&acc)[M][J][4],
                                        float (&part)[M][J][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[m][j][e] = acc[m][j][e] + part[m][j][e];
        part[m][j][e] = 0.0f;
      }
}

// ---------------------------------------------------------------------------
// Tiles
// ---------------------------------------------------------------------------
// The live keys of query row qp are [lo, hi]; lo > hi: a dead row.
__device__ __forceinline__ void live_range(const Params& p, int qp, int* lo,
                                           int* hi) {
  *lo = p.window > 0 ? max(0, qp - p.window + 1) : 0;
  *hi = p.causal ? min(qp, p.T - 1) : p.T - 1;
}

// Does the query tile [q0, q_last] hold a live pair with the key tile
// [k0, k_last]?
__device__ __forceinline__ bool tiles_meet(const Params& p, int q0,
                                           int q_last, int k0, int k_last) {
  if (p.causal && k0 > q_last) return false;
  if (p.window > 0 && k_last < q0 - p.window + 1) return false;
  return true;
}

// A thread's place in the m16n8k8 fragments: g = lane / 4, t = lane % 4;
// in phase 1 its warp's 16 x 16 block of the 32 x 32 pair tile: query
// rows r0 (+ 8), keys c0 + 8j + 2t (+ 1), j = 0, 1.
struct Lane {
  int warp, g, t, r0, c0;
  __device__ Lane()
      : warp(threadIdx.x / 32), g(threadIdx.x % 32 / 4),
        t(threadIdx.x % 4), r0(16 * (warp % 4 / 2) + g),
        c0(16 * (warp % 2)) {}
};

// One k-step (columns d .. d + 7) of the warp's phase-1 block into part.
template <int DP>
__device__ __forceinline__ void score_step(const float* a, const float* b,
                                           int d, float (&part)[1][2][4]) {
  constexpr int kStr = DP + 4;
  uint32_t ah[1][4], al[1][4];
  load_a<kStr>(a + d, ah[0], al[0]);
  const float b0[2] = {b[d], b[8 * kStr + d]};
  const float b1[2] = {b[d + 4], b[8 * kStr + d + 4]};
  mma3_tf32<1, 2>(part, ah, al, b0, b1, 2);
}

// Phase 1: the warp's 16 x 16 block of a.b^T over the first dk8 columns
// (a: the query tile, Q or dO; b: the key tile, K or V; [32][DP + 4]).
// Even and odd k-steps sum in two fragments, so that two chains of mma
// run at once; their float32 sums are taken 64 columns at a time.
template <int DP>
__device__ __forceinline__ void scores(const Lane& L, const float* as,
                                       const float* bs, int dk8,
                                       float (&acc)[1][2][4]) {
  constexpr int kStr = DP + 4;
  const float* a = as + L.r0 * kStr + L.t;
  const float* b = bs + (L.c0 + L.g) * kStr + L.t;
  float even[1][2][4] = {}, odd[1][2][4] = {};
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.0f;
  for (int d0 = 0; d0 < dk8; d0 += 64) {
    const int d1 = min(d0 + 64, dk8);
#pragma unroll 2
    for (int d = d0; d < d1; d += 16) {
      score_step<DP>(a, b, d, even);
      if (d + 8 < d1) score_step<DP>(a, b, d + 8, odd);
    }
    promote(acc, even);
    promote(acc, odd);
  }
}

// Half h of the warp's phase-1 block (its row r0 + 8h: accumulator
// entries 2h, 2h + 1 of each n-tile) into / out of a tile [kBQ][STR].
template <int STR>
__device__ __forceinline__ void put_half(float* tile, const Lane& L, int h,
                                         const float (&x)[2][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
    *reinterpret_cast<float2*>(tile + (L.r0 + 8 * h) * STR + L.c0 + 8 * j
                               + 2 * L.t) = make_float2(x[j][0], x[j][1]);
}

template <int STR>
__device__ __forceinline__ void get_half(const float* tile, const Lane& L,
                                         int h, float (&x)[2][2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float2 u = *reinterpret_cast<const float2*>(
        tile + (L.r0 + 8 * h) * STR + L.c0 + 8 * j + 2 * L.t);
    x[j][0] = u.x;
    x[j][1] = u.y;
  }
}

// P and dS of row r0 + 8h of the warp's block from S (s) and dP (dp), in
// place of s and dp.  Rows past S and keys past T get 0.
__device__ __forceinline__ void probs(const Params& p, const Lane& L,
                                      const float* lse_s, const float* dl_s,
                                      int q0, int k0, int h, float (&s)[2][2],
                                      float (&dp)[2][2]) {
  const int r = L.r0 + 8 * h, qp = q0 + r;
  int lo, hi;
  live_range(p, qp, &lo, &hi);
  const bool dead = lo > hi;
  const float inv_t = 1.0f / static_cast<float>(p.T);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int kp = k0 + L.c0 + 8 * j + 2 * L.t + c;
      float pe = 0.0f, de = 0.0f;
      if (qp < p.S && kp < p.T) {
        if (dead) {
          pe = inv_t;
        } else if (kp >= lo && kp <= hi) {
          float x = s[j][c] * p.scale;
          float th = 0.0f;
          if (p.use_softcap) {
            th = tanhf(x / p.softcap);
            x = p.softcap * th;
          }
          pe = expf(x - lse_s[r]);
          de = pe * (dp[j][c] - dl_s[r]);
          if (p.use_softcap) de = de * (1.0f - th * th);
        }
      }
      s[j][c] = pe;
      dp[j][c] = de;
    }
}

// Phase 1 of both passes: warps 0-3 take S, warps 4-7 dP over the same
// blocks.  Each warp hands the partner of its block (warp +- 4), through
// dss, the half it does not finish: the S warp finishes rows r0, the dP
// warp rows r0 + 8, each leaving P in ps (if non-null) and dS in dss.
// Ends on a barrier.
template <int DP, int STR>
__device__ __forceinline__ void pair_tile(
    const Params& p, const Lane& L, const float* qs, const float* dos,
    const float* ks, const float* vs, const float* lse_s, const float* dl_s,
    int q0, int k0, int dk8, float* ps, float* dss) {
  float x[1][2][4];
  const bool s_warp = L.warp < 4;
  const int h = s_warp ? 0 : 1;            // the half this warp finishes
  scores<DP>(L, s_warp ? qs : dos, s_warp ? ks : vs, dk8, x);
  float mine[2][2], theirs[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      mine[j][c] = s_warp ? x[0][j][c] : x[0][j][2 + c];
      theirs[j][c] = s_warp ? x[0][j][2 + c] : x[0][j][c];
    }
  put_half<STR>(dss, L, 1 - h, theirs);
  __syncthreads();
  get_half<STR>(dss, L, h, theirs);
  float sv[2][2], dpv[2][2];               // S and dP of the half
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sv[j][c] = s_warp ? mine[j][c] : theirs[j][c];
      dpv[j][c] = s_warp ? theirs[j][c] : mine[j][c];
    }
  probs(p, L, lse_s, dl_s, q0, k0, h, sv, dpv);
  if (ps != nullptr) put_half<STR>(ps, L, h, sv);
  put_half<STR>(dss, L, h, dpv);
  __syncthreads();
}

// Phase 2 of the dK/dV pass: acc += tile^T . src over the tile's 32 query
// rows, tile [kBQ][kPS] (P or dS; row = query, column = key), src [kBQ][DP
// + 4] (dO or Q).  The warp takes all 32 keys (two m16 blocks) and the
// n-tiles 4j + warp % 4 of D (j < jn), C at a time, each tile's sum in a
// fresh fragment.  k slot t is query row 2t, slot t + 4 row 2t + 1.
template <int NT, int DP>
__device__ __forceinline__ void acc_keys(float (&acc)[2][NT][4],
                                         const Lane& L, const float* tile,
                                         const float* src, int jn) {
  constexpr int kStr = DP + 4, C = DP >= 192 ? 4 : 2;
  const float* a = tile + 2 * L.t * kPS + L.g;
  const float* b = src + 2 * L.t * kStr + 8 * (L.warp % 4) + L.g;
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += C) {
    if (j0 >= jn) break;                   // warp-uniform
    float part[2][C][4] = {};
#pragma unroll(DP >= 192 ? 4 : 2)
    for (int kk = 0; kk < kBQ; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {        // (key, row): a0, a1 keys +8
        const float* at = a + kk * kPS + 16 * m;
        split_tf32(at[0], ah[m][0], al[m][0]);
        split_tf32(at[8], ah[m][1], al[m][1]);
        split_tf32(at[kPS], ah[m][2], al[m][2]);
        split_tf32(at[kPS + 8], ah[m][3], al[m][3]);
      }
      float b0[C], b1[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        b0[j] = b[kk * kStr + 32 * (j0 + j)];
        b1[j] = b[(kk + 1) * kStr + 32 * (j0 + j)];
      }
      mma3_tf32<2, C>(part, ah, al, b0, b1, jn - j0);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[m][j0 + j][e] = acc[m][j0 + j][e] + part[m][j][e];
  }
}

// Phase 2 of the dQ pass: acc += dS . K over the tile's 32 keys, dss
// [kBQ][kDS] (row = query), ks [kBK][DP + 4].  The warp takes all 32 rows
// (two m16 blocks) and the n-tiles 8j + warp (j < jn), the tile's sum in
// a fresh fragment.  k slot t is key 2t, slot t + 4 key 2t + 1 (one float2
// read of dS for both).
template <int NQ, int DP>
__device__ __forceinline__ void acc_rows(float (&acc)[2][NQ][4],
                                         const Lane& L, const float* dss,
                                         const float* ks, int jn) {
  constexpr int kStr = DP + 4;
  const float* b = ks + 2 * L.t * kStr + 8 * L.warp + L.g;
  float part[2][NQ][4] = {};
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* at = dss + (16 * m + L.g) * kDS + kk + 2 * L.t;
      const float2 x0 = *reinterpret_cast<const float2*>(at);
      const float2 x1 = *reinterpret_cast<const float2*>(at + 8 * kDS);
      split_tf32(x0.x, ah[m][0], al[m][0]);
      split_tf32(x1.x, ah[m][1], al[m][1]);
      split_tf32(x0.y, ah[m][2], al[m][2]);
      split_tf32(x1.y, ah[m][3], al[m][3]);
    }
    float b0[NQ], b1[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      b0[j] = b[kk * kStr + 64 * j];
      b1[j] = b[(kk + 1) * kStr + 64 * j];
    }
    mma3_tf32<2, NQ>(part, ah, al, b0, b1, jn);
  }
  promote(acc, part);
}

// acc (rows 16m + g (+ 8) of the tile, n-tiles `step` j + `first`) times
// `mul` into out [rows of the tile][D] (row stride D), rows below `rows`
// only.
template <int N>
__device__ __forceinline__ void store_frags(float* out, const Lane& L,
                                            const float (&acc)[2][N][4],
                                            int step, int first, float mul,
                                            int rows, int D) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int d = 8 * (step * j + first) + 2 * L.t;
    if (d >= D) continue;                  // D is a multiple of 4
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * m + L.g + 8 * i;
        if (r < rows)
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * D + d) =
              make_float2(acc[m][j][2 * i] * mul,
                          acc[m][j][2 * i + 1] * mul);
      }
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------
// delta[row] = sum_d dO[row, d] o[row, d]: one warp a row, lanes over d in
// float4 steps, then a shuffle tree (a fixed order).
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int rows, int D) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                 // warp-uniform
  const float* a = o + static_cast<size_t>(row) * D;
  const float* b = dout + static_cast<size_t>(row) * D;
  float acc = 0.0f;
  for (int d = 4 * lane; d < D; d += 128) acc = fma4(load4(a + d),
                                                     load4(b + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// At DP >= 192 the shared memory (160-205 KB) leaves one block an SM, so
// the register budget may take the whole file; below, two blocks an SM.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP >= 192 ? 1 : 2)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, float* __restrict__ work,
                int n_split, Params p) {
  constexpr int kTile = kBQ * (DP + 4);
  constexpr int NT = DP / 32;              // n-tiles a warp
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                        // [kBK][DP + 4]
  float* vs = ks + kTile;                  // [kBK][DP + 4]
  float* ring = vs + kTile;                // 2 x (Q, dO) [kBQ][DP + 4]
  float* ps = ring + 4 * kTile;            // [kBQ][kPS]
  float* dss = ps + kBQ * kPS;             // [kBQ][kPS]
  float* rows_s = dss + kBQ * kPS;         // 2 x (lse, delta) [kBQ]

  const Lane L;
  const int split = blockIdx.x;
  const int bkv = blockIdx.y;              // b * KH + KV head
  const int b = bkv / p.KH, g = bkv % p.KH;
  const int group = p.H / p.KH, per = group / n_split;
  const int k0 = blockIdx.z * kBK;         // key tile 0, the heaviest, first
  const int k_rows = min(kBK, p.T - k0);
  const int k_last = k0 + k_rows - 1;
  const int nt = (p.D + 7) / 8;            // n-tiles of D
  const int dk8 = 8 * nt, jn = (nt - L.warp % 4 + 3) / 4;
  stage<kBK, DP>(ks, k + (static_cast<size_t>(bkv) * p.T + k0) * p.D,
                 k_rows, p.D);
  stage<kBK, DP>(vs, v + (static_cast<size_t>(bkv) * p.T + k0) * p.D,
                 k_rows, p.D);

  // The walk: it = head (of the split's) x n_q + query tile, the tiles
  // with a live pair or a dead row only.
  const int n_q = (p.S + kBQ - 1) / kBQ, n_it = per * n_q;
  auto next = [&](int it) {
    while (++it < n_it) {
      const int q0 = it % n_q * kBQ;
      const int q_last = min(q0 + kBQ, p.S) - 1;
      int lo, hi;
      live_range(p, q_last, &lo, &hi);     // dead rows are a suffix
      if (tiles_meet(p, q0, q_last, k0, k_last) || lo > hi) break;
    }
    return it;
  };
  auto issue = [&](int it, int st) {
    const int q0 = it % n_q * kBQ, q_rows = min(kBQ, p.S - q0);
    const int bh = b * p.H + g * group + split * per + it / n_q;
    const size_t row0 = static_cast<size_t>(bh) * p.S + q0;
    float* qs = ring + 2 * st * kTile;
    stage<kBQ, DP>(qs, q + row0 * p.D, q_rows, p.D);
    stage<kBQ, DP>(qs + kTile, dout + row0 * p.D, q_rows, p.D);
    stage_rows(rows_s + 2 * st * kBQ, rows_s + (2 * st + 1) * kBQ,
               lse + row0, delta + row0, q_rows);
  };

  // Warps 0-3 sum dV, warps 4-7 dK.
  const bool v_warp = L.warp < 4;
  float acc[2][NT][4] = {};

  int cur = next(-1);
  if (cur < n_it) issue(cur, 0);
  cp_async_commit();                       // K, V and the first tile
  for (int st = 0; cur < n_it; st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();                       // tile cur in; stage st ^ 1 free
    const int nxt = next(cur);
    if (nxt < n_it) issue(nxt, st ^ 1);    // in flight during this tile
    cp_async_commit();
    const float* qs = ring + 2 * st * kTile;
    const float* dos = qs + kTile;
    const float* lse_s = rows_s + 2 * st * kBQ;
    pair_tile<DP, kPS>(p, L, qs, dos, ks, vs, lse_s, lse_s + kBQ,
                       cur % n_q * kBQ, k0, dk8, ps, dss);
    acc_keys<NT, DP>(acc, L, v_warp ? ps : dss, v_warp ? dos : qs, jn);
    cur = nxt;
  }
  cp_async_wait<0>();                      // K, V if no tile was walked

  // One split: dK and dV themselves.  Several: this split's partials,
  // unscaled, into work [2][n_split][B * KH][T][D] for bwd_reduce_kernel.
  const size_t base = (static_cast<size_t>(bkv) * p.T + k0) * p.D;
  const size_t part = static_cast<size_t>(gridDim.y) * p.T * p.D;
  float* out = v_warp ? (n_split == 1 ? dv : work + (n_split + split) * part)
                      : (n_split == 1 ? dk : work + split * part);
  const float mul = !v_warp && n_split == 1 ? p.scale : 1.0f;
  store_frags<NT>(out + base, L, acc, 4, L.warp % 4, mul, k_rows, p.D);
}

// dk = scale * sum of the splits' partial dK, dv = the sum of their
// partial dV, over the splits in ascending order, one addition at a time
// (no atomics: the same bits every run).  n4: float4s of one partial.
__global__ void __launch_bounds__(kThreads)
bwd_reduce_kernel(const float* __restrict__ work, float* __restrict__ dk,
                  float* __restrict__ dv, long long n4, int n_split,
                  float scale) {
  const float4* w = reinterpret_cast<const float4*>(work);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads
                     + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * kThreads) {
    float4 a = w[i], v4 = w[n_split * n4 + i];
    for (int s = 1; s < n_split; ++s) {
      const float4 x = w[s * n4 + i], y = w[(n_split + s) * n4 + i];
      a.x = a.x + x.x; a.y = a.y + x.y; a.z = a.z + x.z; a.w = a.w + x.w;
      v4.x = v4.x + y.x; v4.y = v4.y + y.y; v4.z = v4.z + y.z;
      v4.w = v4.w + y.w;
    }
    a.x = a.x * scale; a.y = a.y * scale; a.z = a.z * scale;
    a.w = a.w * scale;
    reinterpret_cast<float4*>(dk)[i] = a;
    reinterpret_cast<float4*>(dv)[i] = v4;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP >= 192 ? 1 : 2)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq,
              Params p) {
  constexpr int kTile = kBK * (DP + 4);
  constexpr int NQ = DP / 64;              // n-tiles a warp
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBQ][DP + 4]
  float* dos = qs + kTile;                 // [kBQ][DP + 4]
  float* ring = dos + kTile;               // 2 x (K, V) [kBK][DP + 4]
  float* dss = ring + 4 * kTile;           // [kBQ][kDS]
  float* lse_s = dss + kBQ * kDS;          // [kBQ]
  float* dl_s = lse_s + kBQ;               // [kBQ]

  const Lane L;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = b * p.KH + h / (p.H / p.KH);
  const int qi = gridDim.y - 1 - blockIdx.y;   // heaviest causal first
  const int q0 = qi * kBQ;
  const int q_rows = min(kBQ, p.S - q0);
  const int q_last = q0 + q_rows - 1;
  const int nt = (p.D + 7) / 8;            // n-tiles of D
  const int dk8 = 8 * nt, jn = (nt - L.warp + 7) / 8;
  const size_t row0 = static_cast<size_t>(bh) * p.S + q0;
  stage<kBQ, DP>(qs, q + row0 * p.D, q_rows, p.D);
  stage<kBQ, DP>(dos, dout + row0 * p.D, q_rows, p.D);
  stage_rows(lse_s, dl_s, lse + row0, delta + row0, q_rows);

  const float* kb = k + static_cast<size_t>(kvh) * p.T * p.D;
  const float* vb = v + static_cast<size_t>(kvh) * p.T * p.D;
  const int n_kv = (p.T + kBK - 1) / kBK;
  // Dead rows take no gradient: only key tiles with a live pair count.
  auto next = [&](int t) {
    while (++t < n_kv) {
      const int k0 = t * kBK;
      if (p.causal && k0 > q_last) return n_kv;
      if (tiles_meet(p, q0, q_last, k0, min(k0 + kBK, p.T) - 1)) break;
    }
    return t;
  };
  auto issue = [&](int t, int st) {
    const int k0 = t * kBK, k_rows = min(kBK, p.T - k0);
    float* kt = ring + 2 * st * kTile;
    stage<kBK, DP>(kt, kb + static_cast<size_t>(k0) * p.D, k_rows, p.D);
    stage<kBK, DP>(kt + kTile, vb + static_cast<size_t>(k0) * p.D, k_rows,
                   p.D);
  };

  float acc[2][NQ][4] = {};

  int cur = next(-1);
  if (cur < n_kv) issue(cur, 0);
  cp_async_commit();                       // Q, dO, rows, the first tile
  for (int st = 0; cur < n_kv; st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();                       // tile cur in; stage st ^ 1 free
    const int nxt = next(cur);
    if (nxt < n_kv) issue(nxt, st ^ 1);    // in flight during this tile
    cp_async_commit();
    const float* kt = ring + 2 * st * kTile;
    pair_tile<DP, kDS>(p, L, qs, dos, kt, kt + kTile, lse_s, dl_s, q0,
                       cur * kBK, dk8, nullptr, dss);
    acc_rows<NQ, DP>(acc, L, dss, kt, jn);
    cur = nxt;
  }
  cp_async_wait<0>();                      // Q, dO if no tile was walked
  store_frags<NQ>(dq + row0 * p.D, L, acc, 8, L.warp, p.scale, q_rows, p.D);
}

struct Ptrs {
  const float *q, *k, *v, *o, *lse, *dout;
  float *dq, *dk, *dv, *delta, *work;
};

// Six tiles: the resident pair and the two-stage ring of the streamed
// pair; then P and dS (dK/dV) or dS (dQ), and the rows' lse and delta.
template <int DP>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (6 * kBQ * (DP + 4) + 2 * kBQ * kPS + 4 * kBQ);
}

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(float) * (6 * kBQ * (DP + 4) + kBQ * kDS + 2 * kBQ);
}

template <int DP>
int launch(const Ptrs& t, int B, int n_split, const Params& p, int phases,
           cudaStream_t stream) {
  if (phases & 1) {
    const int rows = B * p.H * p.S;
    const int blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > 0)
      bwd_delta_kernel<<<blocks, kThreads, 0, stream>>>(t.o, t.dout,
                                                        t.delta, rows, p.D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (phases & 2) {
    constexpr size_t smem = dkdv_smem<DP>();
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(n_split, B * p.KH, (p.T + kBK - 1) / kBK);
    if (grid.y > 0 && grid.z > 0)
      bwd_dkdv_kernel<DP><<<grid, kThreads, smem, stream>>>(
          t.q, t.k, t.v, t.dout, t.lse, t.delta, t.dk, t.dv, t.work,
          n_split, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if ((phases & 8) && n_split > 1) {
    const long long n4 = static_cast<long long>(B) * p.KH * p.T * p.D / 4;
    const long long want = (n4 + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(want < 4096 ? want : 4096);
    if (blocks > 0)
      bwd_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
          t.work, t.dk, t.dv, n4, n_split, p.scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (phases & 4) {
    constexpr size_t smem = dq_smem<DP>();
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid(B * p.H, (p.S + kBQ - 1) / kBQ);
    if (grid.x > 0 && grid.y > 0)
      bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
          t.q, t.k, t.v, t.dout, t.lse, t.delta, t.dq, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernels named by `phases` (1: delta, 2: dK/dV, 8: the sum
// of the partials, launched only where n_split > 1, 4: dQ; 15 for a whole
// backward) on `stream`, in that order; returns cudaGetLastError() after
// the launches (0 on success), or cudaErrorInvalidValue for a shape the
// kernels do not take (D > 256 or not a multiple of 4, H not a multiple
// of KH, n_split not dividing the group, a grid past its limits).  All
// tensors float32 and contiguous: q, o, dout, dq [B, H, S, D]; k, v, dk,
// dv [B, KH, T, D]; lse (the forward's) and delta (scratch) [B, H, S];
// work (scratch, n_split > 1 only) [2, n_split, B, KH, T, D].  window <= 0
// means no window; use_softcap == 0 means no softcap.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* work, int B, int H, int KH, int S, int T, int D,
    int n_split, float scale, int causal, int window, int use_softcap,
    float softcap, int phases, void* stream) {
  if (D <= 0 || D > 256 || D % 4 != 0 || KH <= 0 || H % KH != 0 ||
      n_split <= 0 || (H / KH) % n_split != 0 ||
      (n_split > 1 && work == nullptr) || B * KH > 65535 ||
      (T + kBK - 1) / kBK > 65535 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{H, KH, S, T, D, scale, softcap, causal, window,
                 use_softcap};
  const Ptrs t{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(o),
               static_cast<const float*>(lse),
               static_cast<const float*>(dout), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(delta), static_cast<float*>(work)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(t, B, n_split, p, phases, st);
  if (D <= 128) return launch<128>(t, B, n_split, p, phases, st);
  if (D <= 192) return launch<192>(t, B, n_split, p, phases, st);
  return launch<256>(t, B, n_split, p, phases, st);
}

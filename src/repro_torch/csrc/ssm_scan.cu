// Chunked SSD scan for Hopper (sm_90a): the gated linear recurrence of
// Mamba2 (and mLSTM), S_t = exp(ld_t)·S_{t-1} + g_t·k_t v_tᵀ, y_t = q_t·S_t,
// evaluated chunk-parallel in three kernels on the tensor cores.
//
// Replaces the TPU kernel `ssm_scan_call` / `_kernel` of
// src/repro/kernels/ssm_scan/kernel.py (`_kernel` at line 27, the wrapper
// at line 68, pallas_call at line 83).  k, q [B, L, H, N] and v [B, L, H, P]
// (float32 or bfloat16, any strides: Mamba2's B and C come with a head
// stride of 0), log_decay and gate [B, L, H] float32 (any strides) and an
// optional initial state [B, H, N, P] float32 give y [B, L, H, P] and the
// final state [B, H, N, P], both float32.  Any N and P: shared memory grows
// with the chunk only (kernel.py's `plan` says which chunks fit).  With cum
// the within-chunk inclusive sum of log_decay and total its last value, per
// chunk c:
//   1. chunk state:  dS_c    = sum_j exp(total - cum_j) g_j k_j v_jᵀ
//   2. state passing: S_c    = exp(total_c)·S_{c-1} + dS_c, S_{-1} = s0 or 0
//   3. chunk scan:   y_i     = sum_{j<=i} (q_i·k_j) exp(cum_i - cum_j) g_j v_j
//                            + exp(cum_i) · (q_i S_{c-1})
// This is the SSD decomposition: only phase 2 runs over the chunks in
// order, and it moves N·P floats a chunk; phases 1 and 3, which hold the
// products, run every chunk at once.  Any L: the last chunk ends at L,
// which is what the reference's tail padding computes (gate 0 and
// log-decay 0 leave y and the state of the real rows as they are).  The
// plain PyTorch version is src/repro_torch/kernels/ssm_scan/ref.py; the
// same decomposition in float64 is its `three_phase_scan_ref`.
//
// Order and precision of sums, which differ from the plain version's: the
// within-chunk cumsum is accumulated in float64.  It splits the chunk into
// 32 contiguous runs; each lane of one warp sums its run left to right, a
// shuffle scan (Hillis-Steele) gives the runs' inclusive totals, and each
// run adds the total of the runs before it.  Phases 1 and 3 run the same
// code on the same rows, so they see the same cum.  Each decay exponent
// (cum_i - cum_j, total - cum_j, cum_i, total) is taken in float64 and
// rounded once to float32 before expf; none is factored as
// exp(cum_i)·exp(-cum_j), which over- or underflows where |cum| reaches
// tens (deep in a random 81-layer model the per-step log-decay does).  The
// plain version, as the reference, sums and subtracts in float32, which
// loses the digits of cum_i - cum_j where |cum| is much larger; the
// kernel's weights are the more accurate, and chip_smoke.py judges the two
// against a float64 evaluation.  The tensor cores round each of their sums
// toward the accumulator's magnitude, so a chain of products into one
// accumulator loses digits in proportion to its length: each 64-wide N
// slab's part of the scores q·kᵀ and of the carry q·S_{c-1} is summed in
// a fresh accumulator and added to the running sum on the CUDA cores, in
// float32 (at xlstm-125m's N = 384, one chain over all N missed
// chip_smoke.py's gate by 3e-6 of max|y|).  Built with -fmad=false and
// -ftz=true: where exp(cum) falls below float32's normal range the card
// gives 0 where the CPU gives a subnormal.
//
// Products on the tensor cores without losing float32.  float32 inputs:
// `mma.sync.m16n8k8` TF32 with each float32 operand x split into a TF32
// head h = rna(x) and remainder l = rna(x - h) (x - h is exact), and
// a·b ~ ha·hb + ha·lb + la·hb accumulated in float32: a relative error
// near 2^-21 a product where one TF32 rounding gives 2^-11.  bfloat16
// inputs: k, q and v stay bf16 in shared memory (half the bytes) and go to
// `mma.sync.m16n8k16` bf16 (a bf16 product is exact in float32); every
// float32 operand (the weighted scores, S_{c-1}, k_j·w_j) goes in three
// bf16 parts, head, middle and remainder, which carry its 24 bits, on one
// bf16 fragment of the other operand.  tests/test_torch_ssm_scan.py holds
// both in plain arithmetic against float64 at the card's gate.
//
// Bound on the H100: operations.  At zamba2-7b's prefill (B = 4, L =
// 1000, H = 112, N = P = 64, chunk 256) the function's least work is the
// step-by-step recurrence, 5·N·P + N operations a row, 9.2 GFLOP: 0.137 ms
// at the published 67 TFLOP/s of float32 outside the tensor cores.  The
// chunked form needs 22 GFLOP, three times over in split operands: 0.133
// ms at the 495 TFLOP/s of TF32.  Bytes: about 0.24 GB of v, y and the
// state (k and q once each through their head stride of 0), 0.072 ms at
// 3.35 TB/s, plus the chunk states' scratch (phase 1 writes, phase 2 reads
// and writes, phase 3 reads: 4 x 29 MB at zamba2-7b, mostly in L2).
//
// Design, 256 threads (8 warps) a block in phases 1 and 3:
// - Phase 1 (`ssm_chunk_state_kernel`), grid (B·H, chunk, N tile x P
//   tile): a 64 x 64 tile of dS_c.  Each warp owns 16 state rows n and 32
//   columns p; the chunk's rows come in 64-row slabs of k and v through a
//   two-stage `cp.async` ring, and (K∘w)ᵀ is read transposed from the k
//   slab.  The blocks of N and P tile 0 also write the chunk's cumsum and
//   gate to a float64 / float32 scratch and exp(total_c), for phases 2
//   and 3 (phase 3 then never reads log_decay or gate, nor scans).
// - Phase 2 (`ssm_state_pass_kernel`), grid (B·H, N·P / 1024): one thread
//   four elements of the state (float4 where N·P allows) walks the chunks
//   in order, four chunks' loads in flight at once, writes S_{c-1} in
//   place of dS_c in the scratch and the final state.
// - Phase 3 (`ssm_chunk_scan_kernel`), grid (B·H, chunk, query tile x P
//   tile), the heaviest query tiles first: 64 query rows.  Warps w and
//   w + 4 share 16 query rows; each takes half of every 64-key tile (32
//   keys) and half of the carry's k-steps, and the two partial sums meet
//   through shared memory at the end.  N streams through a two-stage ring
//   in 64-column slabs, so that shared memory does not grow with N
//   (xlstm-125m's mLSTM has N = 384): first the carry, a stage a slab
//   holding q's slab and S_{c-1}'s [64 n, 64 p] slab, the carry q·S_{c-1}
//   (half the P tile a pass) starting the accumulator and scaled by
//   exp(cum_i) after the last slab; then, for each 64-row key tile up to
//   the diagonal, a stage a slab holding q's and k's slabs (and, with the
//   last, the v tile).  q is read again for every key tile (from L2).
//   Scores S = Q·Kᵀ accumulate over the slabs in registers, are weighted
//   and masked there after the last, and feed the product with V as A
//   fragments straight from the accumulator layout (TF32: the k index
//   permuted so that a thread's two score columns 2t, 2t+1 are its A slots
//   t, t+4, and V read with the same permutation).  A warp skips the key columns past its last row in
//   the diagonal tile.  Each split product is issued term by term over all
//   of a warp's accumulators, so that no two products in a row wait on one
//   accumulator.
// Every row of k, q and v that a block needs is copied from device memory
// once, at its true strides: 16-byte `cp.async` where rows are aligned
// and contiguous, else 4-byte `cp.async` (float32) or plain loads (bf16);
// rows past the chunk and columns past N or P are zero-filled.  Shared
// rows are padded so that fragment reads are free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;        // phases 1 and 3: 8 warps
constexpr int kPassThreads = 256;    // phase 2
constexpr int kRows = 64;            // rows of a query, key or slab tile
constexpr int kPT = 64;              // columns of a P tile
constexpr int kNT = 64;              // rows of phase 1's N tile
constexpr int kNS = 64;              // columns of phase 3's N slab
constexpr int kSlab = 72;            // phase 1's shared row (k and v)
constexpr int kSmemLimit = 232448;

struct Params {
  const void* k;
  const void* q;
  const void* v;
  const float* ld;
  const float* g;
  const float* s0;                   // null: the state starts at 0
  float* y;
  float* s_out;
  float* ds;                         // [B·H, C, N, P] dS_c, then S_{c-1}
  float* etot;                       // [B·H, C] exp(total_c)
  double* cum;                       // [B·H, C, chunk_pad] cumsum, phase 1
  float* gate;                       // [B·H, C, chunk_pad] the gate, phase 1
  long long sk[4], sq[4], sv[4], sld[3], sg[3];
  int B, L, H, N, P, chunk, C;
  int vec_k, vec_q, vec_v;           // rows aligned for 16-byte copies
};

template <typename T> struct Layout;
// Shared row strides (in elements) of phase 3: q and k slab rows (kNS +
// kQPad), v rows (VS), S_{c-1} slab rows (SS, float).  Each makes its
// fragment reads hit 32 banks.  A slab's width is padded to the k-step of
// the product.
template <> struct Layout<float> {
  static constexpr int kStep = 8;
  static constexpr int kQPad = 4, kVS = 68, kSS = 72;
};
template <> struct Layout<__nv_bfloat16> {
  static constexpr int kStep = 16;
  static constexpr int kQPad = 8, kVS = 72, kSS = 68;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// Copies and fragments
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

// `rows` rows of `width` values (row stride s_row, column stride s_col)
// into dst [rows_pad][stride], zero where r >= rows or c >= width, for
// c < width_pad.  vec: 16-byte copies (s_col == 1, rows 16-byte aligned).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int stride, const T* src,
                                      long long s_row, long long s_col,
                                      int rows, int width, int rows_pad,
                                      int width_pad, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = width_pad / E;
    for (int i = threadIdx.x; i < rows_pad * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * E;
      const int n = r < rows ? max(0, min(E, width - c)) : 0;
      cp_async16(dst + r * stride + c, n ? src + r * s_row + c : src,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
    // One element a thread a pass: bf16 loads held in flight would take
    // registers the chunk scan's accumulators need.
#pragma unroll 1
    for (int i = threadIdx.x; i < rows_pad * width_pad; i += kThreads) {
      const int r = i / width_pad, c = i % width_pad;
      const bool ok = r < rows && c < width;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + r * stride + c, ok ? src + r * s_row + c * s_col
                                           : src, ok ? 4 : 0);
      } else {
        dst[r * stride + c] = ok ? src[r * s_row + c * s_col] : T(0.0f);
      }
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 2^-22 of x: hi its TF32 rounding, lo the rounded
// remainder (x - hi is exact in float32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
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

// d[j] += a·b[j] for J accumulators in split TF32, b[j] the float32 pair
// (b0[j], b1[j]): every b split first, then the three terms pass by pass
// (the two small ones first), so that no two products in a row wait on
// one accumulator.  Only the first `jn` (warp-uniform) take part.
template <int J>
__device__ __forceinline__ void mma3_tf32(float (&d)[J][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float (&b0)[J],
                                          const float (&b1)[J],
                                          int jn = J) {
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
               "{%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                 "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x0, x1) as three bf16 pairs, head, middle and remainder, whose sum is
// x to float32's 24 bits (each remainder is exact in float32).  x0 goes in
// the low half: the lower k index of a fragment register.
__device__ __forceinline__ void split3_bf16(float x0, float x1,
                                            uint32_t& p0, uint32_t& p1,
                                            uint32_t& p2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  p0 = as_u32(h);
  p1 = as_u32(m);
  p2 = as_u32(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d[j] += a·b[j] where a is three bf16 parts (a float32 operand) and
// each b[j] exact; part by part, the smallest first.
template <int J>
__device__ __forceinline__ void mma3_bf16(float (&d)[J][4],
                                          const uint32_t (&a)[3][4],
                                          const uint32_t (&b0)[J],
                                          const uint32_t (&b1)[J]) {
#pragma unroll
  for (int part = 2; part >= 0; --part)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_bf16(d[j], a[part], b0[j], b1[j]);
}

// Part `part` (0 head, 1 middle, 2 remainder; a constant where the caller
// is unrolled) of split3_bf16(x0, x1).
__device__ __forceinline__ uint32_t part3_bf16(float x0, float x1,
                                               int part) {
  uint32_t p0, p1, p2;
  split3_bf16(x0, x1, p0, p1, p2);
  return part == 0 ? p0 : part == 1 ? p1 : p2;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The chunk's inclusive cumsum of log_decay into cum[0, crow) (float64) and
// its gate into gs[0, crow).  Ends with the block synchronised.
__device__ void chunk_cumsum(double* cum, float* gs, const float* ldb,
                             long long s_ld, const float* gb, long long s_g,
                             int crow) {
  for (int r = threadIdx.x; r < crow; r += blockDim.x) {
    cum[r] = static_cast<double>(ldb[r * s_ld]);
    gs[r] = gb[r * s_g];
  }
  __syncthreads();
  if (threadIdx.x < 32) {                  // 32 runs, then a shuffle scan
    const int lane = threadIdx.x;
    const int seg = (crow + 31) / 32;
    const int lo = min(lane * seg, crow), hi = min(lo + seg, crow);
    double run = 0.0;
    for (int r = lo; r < hi; ++r) {
      run += cum[r];
      cum[r] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    double before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) before = 0.0;
    for (int r = lo; r < hi; ++r) cum[r] += before;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Phase 1: dS_c = (K∘w)ᵀ V, one 64 x 64 tile of it a block
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssm_chunk_state_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk_pad = round_up(p.chunk, kRows);
  double* cum = reinterpret_cast<double*>(smem_raw);
  float* gw = reinterpret_cast<float*>(cum + chunk_pad);   // g, then w
  T* ring = reinterpret_cast<T*>(gw + chunk_pad);          // [2][k, v]
  constexpr int kTileElems = kRows * kSlab;

  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n_p = (p.P + kPT - 1) / kPT;
  const int n0 = (blockIdx.z / n_p) * kNT, p0 = (blockIdx.z % n_p) * kPT;
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2]
                + c0 * p.sk[1] + n0 * p.sk[3];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2]
                + c0 * p.sv[1] + p0 * p.sv[3];
  const int wn = min(kNT, p.N - n0), wp = min(kPT, p.P - p0);
  auto issue = [&](int sl) {
    T* ks = ring + (sl & 1) * 2 * kTileElems;
    const int j0 = sl * kRows, rows = min(kRows, crow - j0);
    stage(ks, kSlab, kb + j0 * p.sk[1], p.sk[1], p.sk[3], rows, wn, kRows,
          kNT, p.vec_k);
    stage(ks + kTileElems, kSlab, vb + j0 * p.sv[1], p.sv[1], p.sv[3], rows,
          wp, kRows, kPT, p.vec_v);
    cp_async_commit();
  };
  issue(0);

  chunk_cumsum(cum, gw, p.ld + b * p.sld[0] + h * p.sld[2] + c0 * p.sld[1],
               p.sld[1], p.g + b * p.sg[0] + h * p.sg[2] + c0 * p.sg[1],
               p.sg[1], crow);
  const double total = cum[crow - 1];
  if (blockIdx.z == 0) {                   // for phases 2 and 3
    const size_t at = (static_cast<size_t>(bh) * p.C + c) * chunk_pad;
    for (int r = threadIdx.x; r < crow; r += kThreads) {
      p.cum[at + r] = cum[r];
      p.gate[at + r] = gw[r];
    }
    if (threadIdx.x == 0)
      p.etot[bh * p.C + c] = expf(static_cast<float>(total));
  }
  for (int r = threadIdx.x; r < chunk_pad; r += kThreads)
    gw[r] = r < crow ? expf(static_cast<float>(total - cum[r])) * gw[r]
                     : 0.0f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nr = (warp & 3) * 16;          // the warp's 16 rows n
  const int pc = (warp >> 2) * 32;         // and 32 columns p
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  const int n_sl = (crow + kRows - 1) / kRows;
  for (int sl = 0; sl < n_sl; ++sl) {
    if (sl + 1 < n_sl) {
      issue(sl + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                       // slab sl (and gw) ready
    const T* ks = ring + (sl & 1) * 2 * kTileElems;
    const T* vs = ks + kTileElems;
    const float* w = gw + sl * kRows;
    if constexpr (sizeof(T) == 4) {
#pragma unroll 2
      for (int kk = 0; kk < kRows; kk += 8) {
        // A[n][j] = k_j[n]·w_j, read transposed from the k slab.
        const float* kp = ks + (kk + t) * kSlab + nr + g;
        const float w0 = w[kk + t], w1 = w[kk + t + 4];
        uint32_t ah[4], al[4];
        split_tf32(kp[0] * w0, ah[0], al[0]);
        split_tf32(kp[8] * w0, ah[1], al[1]);
        split_tf32(kp[4 * kSlab] * w1, ah[2], al[2]);
        split_tf32(kp[4 * kSlab + 8] * w1, ah[3], al[3]);
        const float* vp = vs + (kk + t) * kSlab + pc + g;
        float b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[j] = vp[8 * j];
          b1[j] = vp[4 * kSlab + 8 * j];
        }
        mma3_tf32(acc, ah, al, b0, b1);
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < kRows; kk += 16) {
        const int r = kk + 2 * t;
        const T* kp = ks + r * kSlab + nr + g;
        const float w0 = w[r], w1 = w[r + 1], w8 = w[r + 8],
                    w9 = w[r + 9];
        uint32_t a[3][4];
        split3_bf16(to_f(kp[0]) * w0, to_f(kp[kSlab]) * w1, a[0][0],
                    a[1][0], a[2][0]);
        split3_bf16(to_f(kp[8]) * w0, to_f(kp[kSlab + 8]) * w1, a[0][1],
                    a[1][1], a[2][1]);
        split3_bf16(to_f(kp[8 * kSlab]) * w8, to_f(kp[9 * kSlab]) * w9,
                    a[0][2], a[1][2], a[2][2]);
        split3_bf16(to_f(kp[8 * kSlab + 8]) * w8,
                    to_f(kp[9 * kSlab + 8]) * w9, a[0][3], a[1][3], a[2][3]);
        const T* vp = vs + r * kSlab + pc + g;
        uint32_t b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0[j] = pack2(vp[8 * j], vp[kSlab + 8 * j]);
          b1[j] = pack2(vp[8 * kSlab + 8 * j], vp[9 * kSlab + 8 * j]);
        }
        mma3_bf16(acc, a, b0, b1);
      }
    }
    __syncthreads();                       // the slab's stage is free
  }

  float* out = p.ds + (static_cast<size_t>(bh) * p.C + c) * p.N * p.P;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + nr + g + (e >= 2 ? 8 : 0);
      const int col = p0 + pc + 8 * j + 2 * t + (e & 1);
      if (n < p.N && col < p.P)
        out[static_cast<size_t>(n) * p.P + col] = acc[j][e];
    }
}

// ---------------------------------------------------------------------------
// Phase 2: S_c = exp(total_c)·S_{c-1} + dS_c, in chunk order
// ---------------------------------------------------------------------------
// V elements a thread: 4 (float4) where N·P is a multiple of 4, else 1.
template <int V>
__global__ void __launch_bounds__(kPassThreads)
ssm_state_pass_kernel(Params p) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int bh = blockIdx.x;
  const int nv = p.N * p.P / V;            // vectors of one state
  const int e = blockIdx.y * kPassThreads + threadIdx.x;
  if (e >= nv) return;
  Vec s;
  float* sf = reinterpret_cast<float*>(&s);
  if (p.s0 != nullptr) {
    s = reinterpret_cast<const Vec*>(p.s0)[static_cast<size_t>(bh) * nv + e];
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) sf[u] = 0.0f;
  }
  Vec* d = reinterpret_cast<Vec*>(p.ds) + static_cast<size_t>(bh) * p.C * nv
           + e;
  const float* et = p.etot + bh * p.C;
  for (int c0 = 0; c0 < p.C; c0 += 4) {    // 4 chunks' loads in flight
    Vec inc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c0 + c < p.C) inc[c] = d[static_cast<size_t>(c0 + c) * nv];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c0 + c < p.C) {
        d[static_cast<size_t>(c0 + c) * nv] = s;   // S_{c-1}, for phase 3
        const float decay = et[c0 + c];
        const float* xf = reinterpret_cast<const float*>(&inc[c]);
#pragma unroll
        for (int u = 0; u < V; ++u) sf[u] = sf[u] * decay + xf[u];
      }
  }
  reinterpret_cast<Vec*>(p.s_out)[static_cast<size_t>(bh) * nv + e] = s;
}

// ---------------------------------------------------------------------------
// Phase 3: y for 64 rows of a chunk and a P tile
// ---------------------------------------------------------------------------
// One stage of the ring: a 64-row q slab of kNS columns, then k's slab of
// the same shape or S_{c-1}'s slab [kNS rows n][64 columns p] (float), then
// a v tile [64][64].  Its size does not depend on N.
template <typename T>
struct ScanStage {
  using Lay = Layout<T>;
  static constexpr int kQS = kNS + Lay::kQPad;     // q and k row stride
  static constexpr int kQBytes = kRows * kQS * static_cast<int>(sizeof(T));
  static constexpr int kSBytes = kNS * Lay::kSS * 4;
  static constexpr int kKBytes = kQBytes > kSBytes ? kQBytes : kSBytes;
  static constexpr int kVBytes = kRows * Lay::kVS * static_cast<int>(sizeof(T));
  static constexpr int kBytes = kQBytes + kKBytes + kVBytes;
};

// Two blocks an SM (at most 128 registers a thread).  The bf16 kernel,
// whose float32 operands go to the tensor cores in three bf16 parts, fits
// 128 because its slab sums are made two 8-key n-tiles of the scores (8
// registers, not 16) and one 8-column n-tile of the carry at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssm_chunk_scan_kernel(Params p) {
  using Lay = Layout<T>;
  using St = ScanStage<T>;
  constexpr int QS = St::kQS, VS = Lay::kVS, SS = Lay::kSS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk_pad = round_up(p.chunk, kRows);
  double* cum = reinterpret_cast<double*>(smem_raw);
  float* gs = reinterpret_cast<float*>(cum + chunk_pad);
  unsigned char* ring = reinterpret_cast<unsigned char*>(gs + chunk_pad);

  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n_p = (p.P + kPT - 1) / kPT;
  const int n_q = (p.chunk + kRows - 1) / kRows;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.z) / n_p;
  const int p0 = (blockIdx.z % n_p) * kPT;
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  const int r0 = qt * kRows;
  if (r0 >= crow) return;
  const int rows_q = min(kRows, crow - r0);
  const int wp = min(kPT, p.P - p0);
  const bool carry = c > 0 || p.s0 != nullptr;

  // The copies' sources: the block's rows of q, k and v and its P tile of
  // S_{c-1}, kept in shared memory rather than in registers through the
  // step loops (the bf16 kernel's accumulators, scores and split operands
  // need its 128).
  __shared__ const void* src[4];
  if (threadIdx.x == 0) {
    src[0] = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2]
             + (c0 + r0) * p.sq[1];
    src[1] = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2]
             + c0 * p.sk[1];
    src[2] = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2]
             + c0 * p.sv[1] + p0 * p.sv[3];
    src[3] = p.ds + (static_cast<size_t>(bh) * p.C + c) * p.N * p.P + p0;
  }
  __syncthreads();
  // The steps, in order: the carry's N slabs (when there is a carry), then
  // for each key tile kt up to the diagonal its N slabs; step st is N slab
  // st % n_ns of the carry (st < n_ns) or of key tile st / n_ns - 1.
  const int n_ns = (p.N + kNS - 1) / kNS;
  const int n_kt = qt + 1;
  const int first = carry ? 0 : n_ns;
  const int n_steps = n_ns * (1 + n_kt);
  auto issue = [&](int st) {
    unsigned char* base = ring + (st & 1) * St::kBytes;
    const int ns = st % n_ns, n0 = ns * kNS, wn = min(kNS, p.N - n0);
    stage(reinterpret_cast<T*>(base), QS,
          static_cast<const T*>(src[0]) + n0 * p.sq[3], p.sq[1], p.sq[3],
          rows_q, wn, kRows, kNS, p.vec_q);
    if (st < n_ns) {
      stage(reinterpret_cast<float*>(base + St::kQBytes), SS,
            static_cast<const float*>(src[3])
                + static_cast<size_t>(n0) * p.P,
            static_cast<long long>(p.P), 1LL, wn, wp, kNS, kPT,
            (p.P & 3) == 0);
    } else {
      const int j0 = (st / n_ns - 1) * kRows, rows = min(kRows, crow - j0);
      stage(reinterpret_cast<T*>(base + St::kQBytes), QS,
            static_cast<const T*>(src[1]) + j0 * p.sk[1] + n0 * p.sk[3],
            p.sk[1], p.sk[3], rows, wn, kRows, kNS, p.vec_k);
      if (ns == n_ns - 1)                  // v with the key tile's last slab
        stage(reinterpret_cast<T*>(base + St::kQBytes + St::kKBytes), VS,
              static_cast<const T*>(src[2]) + j0 * p.sv[1], p.sv[1],
              p.sv[3], rows, wp, kRows, kPT, p.vec_v);
    }
    cp_async_commit();
  };
  {                                        // the chunk's cum and gate, rows
    const size_t at = (static_cast<size_t>(bh) * p.C + c) * chunk_pad;
    const int rows = r0 + kRows;           // [0, r0 + 64): 16-byte pieces
    for (int i = threadIdx.x; i < rows / 2; i += kThreads)
      cp_async16(cum + 2 * i, p.cum + at + 2 * i, 16);
    for (int i = threadIdx.x; i < rows / 4; i += kThreads)
      cp_async16(gs + 4 * i, p.gate + at + 4 * i, 16);
  }
  issue(first);                            // one group with cum and gate

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // Warps w and w + 4 share the 16 query rows qr; each takes half of every
  // key tile (32 keys from kh) and of the carry's k-steps, and the two
  // partial sums meet at the end.
  const int qr = (warp & 3) * 16, kh = (warp >> 2) * 32;
  float acc[8][4];                         // y, 16 rows x 64 columns
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  // Issues the next step's copies and waits until step st has landed.
  auto land = [&](int st) {
    if (st + 1 < n_steps) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  // The carry's steps, then the key tiles' (two loops, so that the scores
  // are not live in the first).
  int st = first;
  for (; st < n_ns; ++st) {                // acc += q_i S_{c-1}, one slab
    land(st);
    const unsigned char* base = ring + (st & 1) * St::kBytes;
    const T* qs = reinterpret_cast<const T*>(base);
    const int ns = st;
    const int kw = round_up(min(kNS, p.N - ns * kNS), Lay::kStep);
    const float* sp = reinterpret_cast<const float*>(base + St::kQBytes);
    // float32: half the P tile a pass (4 of the 8 n-tiles); bf16: one
    // n-tile a pass.  The slab's part of the carry goes to a fresh
    // accumulator and joins acc on the CUDA cores, as the scores' parts do.
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        float cs[4][4] = {};
        for (int k0 = (warp >> 2) * Lay::kStep; k0 < kw;
             k0 += 2 * Lay::kStep) {
          const float* qa = qs + (qr + g) * QS + k0 + t;
          uint32_t ah[4], al[4];
          split_tf32(qa[0], ah[0], al[0]);
          split_tf32(qa[8 * QS], ah[1], al[1]);
          split_tf32(qa[4], ah[2], al[2]);
          split_tf32(qa[8 * QS + 4], ah[3], al[3]);
          const float* sbp = sp + (k0 + t) * SS + g + 8 * j0;
          float b0[4], b1[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b0[j] = sbp[8 * j];
            b1[j] = sbp[4 * SS + 8 * j];
          }
          mma3_tf32(cs, ah, al, b0, b1);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j0 + j][e] += cs[j][e];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float cs[4] = {};
        for (int k0 = (warp >> 2) * Lay::kStep; k0 < kw;
             k0 += 2 * Lay::kStep) {
          const T* qa = qs + (qr + g) * QS + k0 + 2 * t;
          const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * QS),
                                 ld_u32(qa + 8), ld_u32(qa + 8 * QS + 8)};
          const float* sj = sp + (k0 + 2 * t) * SS + g + 8 * j;
          uint32_t b0[3], b1[3];
          split3_bf16(sj[0], sj[SS], b0[0], b0[1], b0[2]);
          split3_bf16(sj[8 * SS], sj[9 * SS], b1[0], b1[1], b1[2]);
#pragma unroll
          for (int part = 2; part >= 0; --part)
            mma_bf16(cs, a, b0[part], b1[part]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += cs[e];
      }
    }
    if (ns == n_ns - 1) {                  // the carry times exp(cum_i)
      const float e0 = expf(static_cast<float>(
          cum[min(r0 + qr + g, crow - 1)]));
      const float e8 = expf(static_cast<float>(
          cum[min(r0 + qr + g + 8, crow - 1)]));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e8;
        acc[j][3] *= e8;
      }
    }
    __syncthreads();                       // the step's stage is free
  }
  float s[4][4] = {};                      // scores, 16 rows x 32 keys
  for (; st < n_steps; ++st) {
    land(st);
    const unsigned char* base = ring + (st & 1) * St::kBytes;
    const T* qs = reinterpret_cast<const T*>(base);
    const int ns = st % n_ns;
    const int kw = round_up(min(kNS, p.N - ns * kNS), Lay::kStep);
    const int kt = st / n_ns - 1;
    const T* ks = reinterpret_cast<const T*>(base + St::kQBytes);
    // In the diagonal tile the warp's rows see keys up to qr + 15 only:
    // nk of its four 8-key n-tiles (0, 2 or 4).
    const int last = qr + 15 - kh;
    const int nk = kt < qt ? 4 : last < 0 ? 0 : min(4, last / 8 + 1);
    // The slab's part joins the scores on the CUDA cores, in float32: the
    // tensor cores round each sum to the accumulator's magnitude, so one
    // chain over all N would lose digits in proportion to N.
    if constexpr (sizeof(T) == 4) {
      float sl[4][4] = {};                 // the slab's part of the scores
      for (int k0 = 0; k0 < kw; k0 += Lay::kStep) {   // sl = q kᵀ, one slab
        const float* qa = qs + (qr + g) * QS + k0 + t;
        uint32_t ah[4], al[4];
        split_tf32(qa[0], ah[0], al[0]);
        split_tf32(qa[8 * QS], ah[1], al[1]);
        split_tf32(qa[4], ah[2], al[2]);
        split_tf32(qa[8 * QS + 4], ah[3], al[3]);
        float b0[4], b1[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* kp = ks + (kh + 8 * j + g) * QS + k0 + t;
          b0[j] = kp[0];
          b1[j] = kp[4];
        }
        mma3_tf32(sl, ah, al, b0, b1, nk);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = ns == 0 ? sl[j][e] : s[j][e] + sl[j][e];
    } else {
      // Two 8-key n-tiles a pass over the slab: the same sums as four
      // accumulators side by side, in 8 registers.
#pragma unroll
      for (int j0 = 0; j0 < 4; j0 += 2) {
        float sl[2][4] = {};
        if (j0 < nk) {
          for (int k0 = 0; k0 < kw; k0 += Lay::kStep) {
            const T* qa = qs + (qr + g) * QS + k0 + 2 * t;
            const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * QS),
                                   ld_u32(qa + 8), ld_u32(qa + 8 * QS + 8)};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const T* kp = ks + (kh + 8 * (j0 + j) + g) * QS + k0 + 2 * t;
              mma_bf16(sl[j], a, ld_u32(kp), ld_u32(kp + 8));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j0 + j][e] = ns == 0 ? sl[j][e] : s[j0 + j][e] + sl[j][e];
      }
    }
    if (ns == n_ns - 1) {                  // the key tile's scores are whole
      const T* vs = reinterpret_cast<const T*>(base + St::kQBytes
                                               + St::kKBytes);
      // (q_i·k_j)·exp(cum_i - cum_j)·g_j for j <= i, else 0.  Rows past
      // the chunk get what they get: no row mixes with another, and they
      // are never stored; a key past the chunk is past every real row.
      const int i0 = r0 + qr + g;
      const double ci[2] = {cum[min(i0, crow - 1)],
                            cum[min(i0 + 8, crow - 1)]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nk) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int key = kt * kRows + kh + 8 * j + 2 * t + u;
            const int kc = min(key, crow - 1);
            const double ck = cum[kc];
            const float gk = gs[kc];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = s[j][2 * r + u];
              x = key <= i0 + 8 * r
                      ? x * expf(static_cast<float>(ci[r] - ck)) * gk
                      : 0.0f;
            }
          }
        }
      }
      // acc += weighted scores · V
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nk) {
            // A slots t and t + 4 are the keys 2t and 2t + 1 of n-tile j.
            uint32_t ah[4], al[4];
            split_tf32(s[j][0], ah[0], al[0]);
            split_tf32(s[j][2], ah[1], al[1]);
            split_tf32(s[j][1], ah[2], al[2]);
            split_tf32(s[j][3], ah[3], al[3]);
            const float* vp = vs + (kh + 8 * j + 2 * t) * VS + g;
            float b0[8], b1[8];
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              b0[n] = vp[8 * n];
              b1[n] = vp[VS + 8 * n];
            }
            mma3_tf32(acc, ah, al, b0, b1);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          if (j < nk) {                  // keys kh + 8j .. kh + 8j + 15
            const T* vp = vs + (kh + 8 * j + 2 * t) * VS + g;
#pragma unroll
            for (int n0 = 0; n0 < 8; n0 += 4) {  // half the columns a pass
              uint32_t b0[4], b1[4];
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                const T* vn = vp + 8 * (n0 + n);
                b0[n] = pack2(vn[0], vn[VS]);
                b1[n] = pack2(vn[8 * VS], vn[9 * VS]);
              }
              // The scores' bf16 parts, each made where its products are
              // issued (the smallest first): 4 registers, not 12.
#pragma unroll
              for (int part = 2; part >= 0; --part) {
                const uint32_t a[4] = {
                    part3_bf16(s[j][0], s[j][1], part),
                    part3_bf16(s[j][2], s[j][3], part),
                    part3_bf16(s[j + 1][0], s[j + 1][1], part),
                    part3_bf16(s[j + 1][2], s[j + 1][3], part)};
#pragma unroll
                for (int n = 0; n < 4; ++n)
                  mma_bf16(acc[n0 + n], a, b0[n], b1[n]);
              }
            }
          }
        }
      }
    }
    __syncthreads();                       // the step's stage is free
  }

  // The second half's partial sums through the free ring, fragment by
  // fragment, into the first half's.
  float* red = reinterpret_cast<float*>(ring) + (warp & 3) * 8 * 4 * 32
               + lane;
  if (kh) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(j * 4 + e) * 32] = acc[j][e];
  }
  __syncthreads();
  if (kh) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] += red[(j * 4 + e) * 32];
      const int i = r0 + qr + g + (e >= 2 ? 8 : 0);
      const int col = p0 + 8 * j + 2 * t + (e & 1);
      if (i < crow && col < p.P)
        p.y[((static_cast<size_t>(b) * p.L + c0 + i) * p.H + h) * p.P + col]
            = acc[j][e];
    }
}

// Shared bytes of phases 1 and 3 (kernel.py's `smem_bytes` says the same).
template <typename T>
size_t state_smem(const Params& p) {
  const int chunk_pad = round_up(p.chunk, kRows);
  return 12 * static_cast<size_t>(chunk_pad)
         + 2 * 2 * kRows * kSlab * sizeof(T);
}

template <typename T>
size_t scan_smem(const Params& p) {
  const int chunk_pad = round_up(p.chunk, kRows);
  return 12 * static_cast<size_t>(chunk_pad) + 2 * ScanStage<T>::kBytes;
}

// phases: bit 0 chunk state, bit 1 state passing, bit 2 chunk scan (7 for
// the function; one bit alone times that kernel on the scratch as it is).
template <typename T>
int launch(const Params& p, int phases, cudaStream_t stream) {
  const size_t sm1 = state_smem<T>(p), sm3 = scan_smem<T>(p);
  if (sm1 > kSmemLimit || sm3 > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      ssm_chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm1));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(ssm_chunk_scan_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sm3));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_p = (p.P + kPT - 1) / kPT;
  const int n_n = (p.N + kNT - 1) / kNT;
  const int n_q = (p.chunk + kRows - 1) / kRows;
  const unsigned bh = static_cast<unsigned>(p.B * p.H);
  if (phases & 1) {
    ssm_chunk_state_kernel<T><<<dim3(bh, p.C, n_n * n_p), kThreads, sm1,
                                stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (phases & 2) {
    const int np = p.N * p.P;
    if (np % 4 == 0)
      ssm_state_pass_kernel<4><<<dim3(bh, (np / 4 + kPassThreads - 1)
                                              / kPassThreads),
                                 kPassThreads, 0, stream>>>(p);
    else
      ssm_state_pass_kernel<1><<<dim3(bh, (np + kPassThreads - 1)
                                          / kPassThreads),
                                 kPassThreads, 0, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (phases & 4) {
    ssm_chunk_scan_kernel<T><<<dim3(bh, p.C, n_q * n_p), kThreads, sm3,
                               stream>>>(p);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

}  // namespace

// Launches the three kernels on `stream`; returns the first
// cudaGetLastError() that is not 0 (0 on success), or
// cudaErrorInvalidValue for a shape the kernels do not take (an empty
// input, chunk outside [1, L], more than 65535 chunks, or more shared
// memory than a block may have).  bf16 != 0: k, q and v are bfloat16,
// else float32.  `strides` (host memory, in elements): k's four, q's
// four, v's four, log_decay's three and gate's three.  vec: bit 0 k, bit
// 1 q, bit 2 v may be copied in 16-byte pieces (last stride 1, the others
// and the base 16-byte aligned).  s0 is a contiguous float32 [B, H, N, P]
// or null; y [B, L, H, P] and s_out [B, H, N, P] are contiguous float32;
// ds [B, H, C, N, P], etot [B, H, C] and gate [B, H, C, chunk_pad] are
// float32 scratch and cum [B, H, C, chunk_pad] float64 scratch, C =
// ceil(L / chunk), chunk_pad = chunk rounded up to a multiple of 64.
// phases selects the kernels to launch (7: all three, the function).
extern "C" int ssm_scan_launch(const void* k, const void* q, const void* v,
                               const void* ld, const void* g, const void* s0,
                               void* y, void* s_out, void* ds, void* etot,
                               void* cum, void* gate,
                               const long long* strides, int bf16, int vec,
                               int B, int L, int H, int N, int P, int chunk,
                               int phases, void* stream) {
  if (B < 1 || L < 1 || H < 1 || N < 1 || P < 1 || chunk < 1 || chunk > L)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.k = k;
  p.q = q;
  p.v = v;
  p.ld = static_cast<const float*>(ld);
  p.g = static_cast<const float*>(g);
  p.s0 = static_cast<const float*>(s0);
  p.y = static_cast<float*>(y);
  p.s_out = static_cast<float*>(s_out);
  p.ds = static_cast<float*>(ds);
  p.etot = static_cast<float*>(etot);
  p.cum = static_cast<double*>(cum);
  p.gate = static_cast<float*>(gate);
  for (int i = 0; i < 4; ++i) {
    p.sk[i] = strides[i];
    p.sq[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
  }
  for (int i = 0; i < 3; ++i) {
    p.sld[i] = strides[12 + i];
    p.sg[i] = strides[15 + i];
  }
  p.B = B;
  p.L = L;
  p.H = H;
  p.N = N;
  p.P = P;
  p.chunk = chunk;
  p.C = (L + chunk - 1) / chunk;
  if (p.C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  p.vec_k = vec & 1;
  p.vec_q = (vec >> 1) & 1;
  p.vec_v = (vec >> 2) & 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, phases, st)
              : launch<float>(p, phases, st);
}

// Backward of the chunked SSD scan for Hopper (sm_90a): the gradients of the
// gated linear recurrence S_t = exp(ld_t)·S_{t-1} + g_t·k_t v_tᵀ, y_t =
// q_t·S_t (csrc/ssm_scan.cu) with respect to k, q, v, log_decay, gate and
// the initial state, given dy and the final state's gradient dS_final.
//
// Replaces no TPU kernel: the TPU kernel `ssm_scan_call` of
// src/repro/kernels/ssm_scan/kernel.py has no backward pass, and the
// reference trains through `jax.value_and_grad` of its plain
// `chunked_linear_scan` (src/repro/models/ssm.py:38).  On the card a CUDA
// tensor may not fall back to autograd through the plain version, so the
// backward is a kernel too.  The plain PyTorch version is
// `linear_scan_bwd_ref` in src/repro_torch/kernels/ssm_scan/ref.py, the
// same four phases.  With cum the within-chunk inclusive sum of log_decay,
// total its last value, S_{c-1} the state entering chunk c (the forward's
// scratch) and G_c the gradient of the state leaving it (G_{C-1} =
// dS_final, zero when absent):
//   0. chunk cumsum:  cum and exp(total_c), as the forward computes them;
//   1. chunk d-state: ΔG_c = Σ_i exp(cum_i) q_i dy_iᵀ  (the forward's chunk
//                     state with (q, dy) in the role of (k, v));
//   2. reverse pass:  G_{c-1} = exp(total_c)·G_c + ΔG_c, from the last chunk
//                     back; d_initial_state = G_{-1};
//   3. chunk backward (2b: the carries of the state into it), with the
//      decayed score tiles of a (query tile i, key tile j) pair W_ij =
//      (dy_i·v_j) exp(cum_i - cum_j) and W'_ij = (q_i·k_j) exp(cum_i -
//      cum_j), i >= j:
//        dq_i  = Σ_{j<=i} W_ij (g_j k_j) + exp(cum_i) S_{c-1} dy_i,
//        dk̃_j = Σ_{i>=j} W_ij q_i + exp(total - cum_j) G_c v_j,
//        dṽ_j = Σ_{i>=j} W'_ij dy_i + exp(total - cum_j) G_cᵀ k_j,
//        dk = g·dk̃, dv = g·dṽ, and the partial dot products q·dq and
//        k·dk̃ of each 64-column tile of N;
//   4. d log_decay:   dg_m = k_m·dk̃_m and d cum_m = q_m·dq_m - g_m dg_m
//                     (+ <S_final, dS_final> at the last position) from the
//                     tiles' partial sums, and d ld_t = Σ_{m>=t} d cum_m.
// Nothing divides by the gate: padded and zero-gate rows have g = 0.  k
// and q are read through their strides (Mamba2's B and C come with a head
// stride of 0); dk, dq, dv, d ld, dg are written densely, one row a head,
// and autograd's expand backward sums a broadcast over the heads.
//
// Design.  Every product of phases 1, 2b and 3 is a 64 x 64 output tile of
// a 256-thread block (eight warps, a 32 x 16 eighth each) on the tensor
// cores, `mma.sync.m16n8k8` TF32 in split operands (below), its operands
// 64 x 64 tiles in shared memory, a hi and a lo plane each.  It replaces
// a design that ran every product in float32 on the CUDA cores (4 x 4
// outputs a thread from 32-deep slabs) and formed each dy·vᵀ score tile
// twice, in a dq and a dk kernel, and had kept the forward's split-TF32
// tiles off because phase 1 wants another row weight and the Wᵀ·Y
// products contract a score tile over its query or key index.  Here the
// row weight is applied as the operand is staged, and every product,
// transposed or not, reads operands that the staging laid out for it.
// Each operand is split once, as it is staged: cp.async copies the
// tile's elements through the strides (zero past its rows and columns,
// 16 bytes at a time where the rows allow) as raw floats, then one pass
// scales a row where the product wants it (exp(cum_i) for phase 1's q,
// the gate for dq's g_j k_j), splits it and writes hi and lo in the
// layout the product reads, A operands depth-major (a[k][m]), B operands
// depth-minor (b[n][k]): a transpose, where one is needed, is folded into
// that pass.  The score tiles W and W' are split once as they leave the
// accumulators, W stored [i][j] (the A operand of Wᵀ·q and the B operand
// of (g k)ᵀ·Wᵀ), W' [j][i].  The fragments' rows, depth and columns are
// permuted (see Lane) so that each register pair an operand needs is one
// 8-byte load that hits its own bank: a k-step of a warp loads 12 pairs
// for 12 mma and splits nothing.
// - phase 1, grid (B·H, C, N tiles x P tiles): a 64 x 64 tile of ΔG_c, the
//   chunk's rows in 64-row steps, the next step's copies in flight in two
//   raw tiles while the step before computes;
// - phase 2, grid (B·H, N·P / 256): one element of the state a thread, its
//   ΔG of eight chunks loaded at a time;
// - phase 2b, grid (B·H, C, 3 x column tiles): the carries into phase 3,
//   exp(total - cum_j) G_c v_j (into dk), exp(total - cum_j) G_cᵀ k_j
//   (into dv) and exp(cum_i) S_{c-1} dy_i (into the diagonal pairs' dq
//   partials), one column tile of one a block, the chunk's row tiles in
//   turn, its copies in flight as in phase 1;
// - phase 3, grid (B·H, C, 2 x key tiles), the heaviest key tile first:
//   blocks of even z own key tile z/2's dk̃ and the dq partials, blocks of
//   odd z its dṽ, two blocks an SM, their copies landing in place.  A dk̃
//   block forms each W_ij of its key tile once (i from j's tile to the
//   chunk's end, the product over P in 64-wide slabs), then for each
//   64-column tile of N takes dk̃ += Wᵀ·q_i and the partial dq_i(j) =
//   W·(g k)_j from the same W; a dṽ block forms W' and takes dṽ +=
//   W'ᵀ·dy_i.  Their sums start from phase 2b's carries.  Where N (or P)
//   spans several tiles, the running dk̃ (dṽ) of a column tile waits in
//   the output, unscaled, between query tiles: the thread that stored it
//   reads it back;
// - phase 3b, grid (B·H, C, query tiles x N tiles), the heaviest first:
//   dq_i = Σ_{j<=i} dq_i(j), the partials read from the workspace, each
//   thread's elements in a float4 run (the layout the dk̃ blocks stored);
// - phase 4, grid (B·H): one block a head walks L from the end in pieces of
//   2048 positions, one warp scanning each piece.
// On a diagonal tile pair the products skip what lies wholly above the
// diagonal: the score eighths with no j <= i, and the k-steps of Wᵀ·q
// (W·(g k)) with every i < j (j > i).
//
// Determinism: no atomics.  Every sum split over blocks goes to a
// workspace and is added in an order fixed by the shapes: dq_i's partials
// in ascending key tile j, the diagonal pair's last (its carry first, then
// its W·(g k)) (phase 3b), and q·dq, k·dk̃ one slot a 64-column tile of N,
// added by phase 4 in tile order.  Within a block a tile's sum runs its
// k-steps in order into a fresh fragment and is then added to the
// float32 sum; the rows' (columns') dot products add a thread's columns
// (rows) in order, then the lanes of a row (column) by a fixed butterfly,
// then the warps in warp order.  The tiling comes from kernel.plan_bwd, a
// function of the shapes alone: the C entry refuses any other.  Two runs
// are bitwise equal.
//
// Precision: each float32 operand x goes to the tensor cores as hi, its
// TF32 rounding (by integer arithmetic, never cvt), and lo = x - hi
// rounded the same way; a·b ~ la·hb + ha·lb + ha·hb, within about 2^-21 of
// a product where one TF32 term gives 2^-11.  The tensor cores truncate
// their running sums, so a fragment sums at most 64 of depth (one staged
// tile, 24 mma) and is then added into float32 accumulators outside the
// mma.  Row scales and masks are float32 products on the CUDA cores
// (-fmad=false: nothing is contracted unless written as fmaf).  cum is
// summed in float64 (the forward's order), and each decay exponent is
// taken in float64 and rounded once before IEEE expf, as the forward
// does.  Phase 4 sums the partial dot products and runs the L-long reverse
// cumsum in float64: d cum is a difference of two large dot products, and
// a float32 running sum over L positions would add a rounding of the
// running magnitude at each step.
//
// Bound on the H100: operations, at least the smaller of the chunked
// form's and the recurrence's counts against 67 TFLOP/s of float32 outside
// the tensor cores, and three TF32 products of the chunked form's count
// against 495 TFLOP/s; chip_smoke.py prints both from the call's shapes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // eight warps
constexpr int kWarpsN = 4;          // warps across an output tile's columns
constexpr int kNJ = 2;              // n8 fragments of a warp's columns
constexpr int kT = 64;              // rows and columns of a tile
constexpr int kS = kT + 4;          // floats a staged row (68 = 4 mod 16)
constexpr int kPiece = 2048;        // positions phase 4 scans at a time
constexpr int kAhead = 8;           // chunks phase 2 loads at a time
constexpr int kSmemLimit = 232448;

struct Params {
  const float* k;
  const float* q;
  const float* v;
  const float* dy;
  const float* ld;
  const float* g;
  const float* d_final;             // [B·H, N, P] or null (zero)
  const float* states;              // [B·H, C, N, P] S_{c-1}
  const float* s_final;             // [B·H, N, P]
  float* dk;                        // [B, L, H, N]
  float* dq;                        // [B, L, H, N]
  float* dv;                        // [B, L, H, P]
  float* dld;                       // [B, L, H]
  float* dg;                        // [B, L, H]
  float* d_init;                    // [B·H, N, P]
  float* gs;                        // [B·H, C, N, P] ΔG_c, then G_c
  double* cum;                      // [B·H, C, chunk_pad]
  float* etot;                      // [B·H, C] exp(total_c)
  float* qdq;                       // [N tiles, B·H, L] q·dq, a tile's part
  float* kdk;                       // [N tiles, B·H, L] k·dk̃, a tile's part
  float* dqp;                       // [B·H, C, pairs, N tiles, 4096]
  long long sk[4], sq[4], sv[4], sdy[4], sld[3], sg[3];
  int B, L, H, N, P, chunk, C, chunk_pad, has_s0;
  int n_q, n_n, n_p, pairs;         // query tiles a chunk, N and P tiles
};

__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }

__device__ __forceinline__ int round8(int x) { return (x + 7) & ~7; }

// The chunk's inclusive cumsum of log_decay into cum[0, crow) in float64:
// the forward's `chunk_cumsum` (32 contiguous runs, each summed left to
// right by one lane, a shuffle scan of the runs' totals), so that both
// see the same cum.  Ends with the block synchronised.
__device__ void chunk_cumsum(double* cum, const float* ldb, long long s_ld,
                             int crow) {
  for (int r = threadIdx.x; r < crow; r += blockDim.x)
    cum[r] = static_cast<double>(ldb[r * s_ld]);
  __syncthreads();
  if (threadIdx.x < 32) {
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
// Split TF32
// ---------------------------------------------------------------------------
// x rounded to TF32 (to nearest, ties away from zero: the result of
// cvt.rna.tf32.f32) by integer arithmetic on its bits.
__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint2& a01,
                                         const uint2& a23, const uint2& b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a01.x), "r"(a01.y), "r"(a23.x), "r"(a23.y), "r"(b.x), "r"(b.y));
}

// A staged tile: the hi plane, then the lo plane, each 64 rows of kS
// floats.  An A operand (rows m of the product, depth k) is stored as
// a[k][m], a B operand (depth k, columns n) as b[n][k].
constexpr int kPlane = kT * kS;

// A thread's place: warp w takes rows m0 = 32 (w / 4) .. + 31 and columns
// n0 = 16 (w % 4) .. + 15 of a 64 x 64 output tile, as 2 x 2 m16n8k8
// fragments; g = lane / 4, t = lane % 4.  The fragments' rows, depth and
// columns are permuted so that every operand register pair is one 8-byte
// shared load: fragment row g (g + 8) is row 2g (2g + 1) of its 16, depth
// slot t (t + 4) is depth 2t (2t + 1) of its 8, in A and B alike, and
// fragment column c is column pi(c) of its 8, pi = 0 2 4 6 1 3 5 7.  With
// rows of kS = 68 floats, A's pair loads (4t + g mod 16 in 8-byte banks)
// and B's (2 pi(g) + t) hit distinct banks in each half warp.  The
// accumulator element (mi, nj, e) is row m0 + 16 mi + 2g + e / 2, column
// n0 + 8 nj + pi(2t + e % 2).
__device__ __forceinline__ int perm8(int c) {
  return c < 4 ? 2 * c : 2 * c - 7;
}

struct Lane {
  int m0, n0, g, t, wn;
  __device__ Lane()
      : m0(32 * (threadIdx.x / (32 * kWarpsN))),
        n0(16 * (threadIdx.x / 32 % kWarpsN)), g(threadIdx.x % 32 / 4),
        t(threadIdx.x % 4), wn(threadIdx.x / 32 % kWarpsN) {}
  __device__ int row(int mi, int e) const {
    return m0 + 16 * mi + 2 * g + (e >> 1);
  }
  __device__ int col(int nj, int e) const {
    return n0 + 8 * nj + perm8(2 * t + (e & 1));
  }
};

using Acc = float[2][kNJ][4];

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[mi][nj][e] = 0.0f;
}

// One k-step (depth k0 .. k0 + 7) of the warp's fragments into part,
// three terms pass by pass (the two small ones first: lo·hi, hi·lo,
// hi·hi); pa and pb at the thread's first A and B pair.
__device__ __forceinline__ void k_step(Acc& part, const float* pa,
                                       const float* pb, int k0) {
  uint2 ah[2][2], al[2][2], bh[kNJ], bl[kNJ];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* x = pa + (k0 + s) * kS + 16 * mi;
      ah[mi][s] = *reinterpret_cast<const uint2*>(x);
      al[mi][s] = *reinterpret_cast<const uint2*>(x + kPlane);
    }
#pragma unroll
  for (int nj = 0; nj < kNJ; ++nj) {
    const float* x = pb + 8 * nj * kS + k0;
    bh[nj] = *reinterpret_cast<const uint2*>(x);
    bl[nj] = *reinterpret_cast<const uint2*>(x + kPlane);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
      mma_tf32(part[mi][nj], al[mi][0], al[mi][1], bh[nj]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
      mma_tf32(part[mi][nj], ah[mi][0], ah[mi][1], bl[nj]);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
      mma_tf32(part[mi][nj], ah[mi][0], ah[mi][1], bh[nj]);
}

// acc += A·B over depth k in [k_lo, k_hi) (multiples of 8, k_hi - k_lo at
// most 64: one staged tile), the warp's 32 x 16 eighth; A and B staged
// tiles (a[k][m], b[n][k]).  The k-steps sum into a fresh fragment, which
// is then added into acc.  Operands past a tile's rows or columns are
// zero, so every fragment runs; a warp whose eighth a caller knows to be
// zero skips the call.
__device__ __forceinline__ void mma_tile(Acc& acc, const float* a,
                                         const float* b, int k_lo,
                                         int k_hi) {
  const Lane L;
  Acc part;
  zero(part);
  const float* pa = a + 2 * L.t * kS + L.m0 + 2 * L.g;
  const float* pb = b + (L.n0 + perm8(L.g)) * kS + 2 * L.t;
#pragma unroll 1
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) k_step(part, pa, pb, k0);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[mi][nj][e] = acc[mi][nj][e] + part[mi][nj][e];
}

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous 4-byte copy into shared memory; `valid` 0 zero-fills.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// A 64 x 64 operand in device memory: element (r, c) at x[r·s_row +
// c·s_col], zero past `rows` and `width`, times scale[r] where `scale` is
// given (a row factor in shared memory); `trans`: staged as [c][r].  A
// null x stages nothing.
struct Src {
  const float* x;
  long long s_row, s_col;
  int rows, width;
  bool trans;
  const float* scale;
};

// Staging, in two halves so that a tile's copies can fly while the
// products of the tile before it run: issue() starts cp.async copies of
// the operand's elements into a raw buffer (rows of kS floats), 16 bytes
// at a time where the rows allow it (unit column stride, rows and base
// 16-byte aligned), else 4; once they have landed, the block reads the
// raw tile four columns at a time, a thread a row (the 8 rows a quarter
// warp reads lie on distinct bank groups), and writes each element as the
// TF32 split of scale[r]·x, hi and lo in their planes of the staged tile,
// as [r][c] (float4 stores) or [c][r] (a warp's stores on 32 neighbouring
// floats).  Each operand is split once.
constexpr int kGroups = kT / 4;             // 4-column groups a row
constexpr int kVecPer = kT * kGroups / kThreads;   // 16-byte copies a thread
constexpr int kPer = kT * kT / kThreads;    // 4-byte copies a thread
constexpr int kStep = kThreads / kT;        // rows or groups between them

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void issue(float* raw, const Src& a) {
  if (a.x == nullptr) return;
  const bool vec = a.s_col == 1 && a.s_row % 4 == 0
                   && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  if (vec) {                                // a thread a 4-column group
    const int cg = threadIdx.x % kGroups, r0 = threadIdx.x / kGroups;
    const int valid = min(4, a.width - 4 * cg);
    const float* src = a.x + r0 * a.s_row + 4 * cg;
#pragma unroll
    for (int i = 0; i < kVecPer; ++i) {
      const int r = r0 + (kThreads / kGroups) * i;
      const bool ok = valid > 0 && r < a.rows;
      cp_async16(raw + r * kS + 4 * cg,
                 ok ? src + i * (kThreads / kGroups) * a.s_row : a.x,
                 ok ? 4 * valid : 0);
    }
    return;
  }
  const int c = threadIdx.x % kT, r0 = threadIdx.x / kT;   // a column
  const bool col_ok = c < a.width;
  const float* src = a.x + r0 * a.s_row + c * a.s_col;
#pragma unroll 8
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + kStep * i;
    const bool ok = col_ok && r < a.rows;
    cp_async4(raw + r * kS + c, ok ? src + i * kStep * a.s_row : a.x, ok);
  }
}

// A thread's part of a raw tile, times the row factor: row tid % 64, its
// 4-column groups tid / 64 + kStep·i.
using Raw = float4[kPer / 4];

__device__ __forceinline__ void load_raw(Raw& v, const float* raw,
                                         const Src& a) {
  if (a.x == nullptr) return;
  const int r = threadIdx.x % kT, g0 = threadIdx.x / kT;
  const float s = r >= a.rows ? 0.0f : a.scale != nullptr ? a.scale[r] : 1.0f;
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    float4 x = *reinterpret_cast<const float4*>(raw + r * kS
                                                + 4 * (g0 + kStep * i));
    x.x *= s;
    x.y *= s;
    x.z *= s;
    x.w *= s;
    v[i] = x;
  }
}

__device__ __forceinline__ void store_split(float* dst, const Raw& v,
                                            const Src& a) {
  if (a.x == nullptr) return;
  const int r = threadIdx.x % kT, g0 = threadIdx.x / kT;
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    const int c = 4 * (g0 + kStep * i);
    const float x[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
    float hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      hi[u] = to_tf32(x[u]);
      lo[u] = to_tf32(x[u] - hi[u]);
    }
    if (a.trans) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dst[(c + u) * kS + r] = hi[u];
        dst[kPlane + (c + u) * kS + r] = lo[u];
      }
    } else {
      *reinterpret_cast<float4*>(dst + r * kS + c) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(dst + kPlane + r * kS + c) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

// The split of a raw tile in its own hi plane: a thread's elements, a
// row's 4-column groups, go back where they were (hi) and into the lo
// plane as it reads them; transposed, the block reads the whole tile
// before any element moves.  The block is synchronised before and after
// a transposed operand.
__device__ __forceinline__ void split_in_place(float* dst, const Src& a) {
  if (a.x == nullptr) return;
  if (a.trans) {
    Raw v;
    load_raw(v, dst, a);
    __syncthreads();
    store_split(dst, v, a);
    return;
  }
  const int r = threadIdx.x % kT, g0 = threadIdx.x / kT;
  const float s = r >= a.rows ? 0.0f : a.scale != nullptr ? a.scale[r] : 1.0f;
#pragma unroll
  for (int i = 0; i < kPer / 4; ++i) {
    const int c = 4 * (g0 + kStep * i);
    const float4 x = *reinterpret_cast<const float4*>(dst + r * kS + c);
    const float v[4] = {x.x * s, x.y * s, x.z * s, x.w * s};
    float hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      hi[u] = to_tf32(v[u]);
      lo[u] = to_tf32(v[u] - hi[u]);
    }
    *reinterpret_cast<float4*>(dst + r * kS + c) =
        make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(dst + kPlane + r * kS + c) =
        make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Shared memory of phases 1 and 3: the chunk's cum (float64) and gate (or
// a row factor), the rows' dot products of four warps, two staged tiles
// and, in phase 3, the score tile; phases 1 and 3b also two raw tiles.
__host__ __device__ inline size_t tile_smem(int chunk_pad, bool phase3) {
  return 12 * static_cast<size_t>(chunk_pad) + kWarpsN * kT * 4
         + static_cast<size_t>(phase3 ? 3 : 2) * 2 * kPlane * 4
         + (phase3 ? 0 : 2 * static_cast<size_t>(kPlane) * 4);
}

struct Tile {
  double* cum;
  float* gate;
  float* red;                       // [kWarpsN][64]
  float* x;                         // staged operands
  float* y;
  float* ra;                        // their raw tiles, or null: in place
  float* rb;
  float* w;                         // the score tile (phase 3)

  // Starts the copies of a (into x's raw tile) and b (y's); with no raw
  // tiles (phase 3), land() starts them itself.
  __device__ void prefetch(const Src& a, const Src& b) const {
    issue(ra, a);
    issue(rb, b);
    cp_async_commit();
  }

  // Waits for the copies of a and b and splits them into x and y; ends
  // with the block synchronised.  The products before it must be done
  // with x and y: its first barrier sees to that.  In place, the copies
  // land in x's and y's hi planes and are split there.
  __device__ void land(const Src& a, const Src& b) const {
    if (ra == nullptr) {
      __syncthreads();
      issue(x, a);
      issue(y, b);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      split_in_place(x, a);
      split_in_place(y, b);
    } else {
      Raw v;
      cp_async_wait_all();
      __syncthreads();
      load_raw(v, ra, a);
      store_split(x, v, a);
      load_raw(v, rb, b);
      store_split(y, v, b);
    }
    __syncthreads();
  }
};

// Carves the shared memory (phase 3: the score tile, staging in place) and
// loads the chunk's cum (phase 0's) and gate.
__device__ Tile load_chunk(const Params& p, int bh, int c, int crow,
                           bool phase3 = false) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile t;
  t.cum = reinterpret_cast<double*>(smem_raw);
  t.gate = reinterpret_cast<float*>(t.cum + p.chunk_pad);
  t.red = t.gate + p.chunk_pad;
  t.x = t.red + kWarpsN * kT;
  t.y = t.x + 2 * kPlane;
  t.ra = phase3 ? nullptr : t.y + 2 * kPlane;
  t.rb = phase3 ? nullptr : t.ra + kPlane;
  t.w = phase3 ? t.y + 2 * kPlane : nullptr;
  const int b = bh / p.H, h = bh % p.H;
  const double* cg = p.cum + (static_cast<size_t>(bh) * p.C + c) * p.chunk_pad;
  const float* gb = p.g + b * p.sg[0] + h * p.sg[2]
                    + static_cast<long long>(c) * p.chunk * p.sg[1];
  for (int r = threadIdx.x; r < crow; r += kThreads) {
    t.cum[r] = cg[r];
    t.gate[r] = gb[r * p.sg[1]];
  }
  __syncthreads();
  return t;
}

// acc's row m times f(m), for the rows below `rows` (others are zero).
template <class F>
__device__ __forceinline__ void scale_rows(Acc& acc, int rows, F f) {
  const Lane L;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = L.row(mi, 2 * h);
      const float s = m < rows ? f(m) : 0.0f;
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj) {
        acc[mi][nj][2 * h] *= s;
        acc[mi][nj][2 * h + 1] *= s;
      }
    }
}

// The decayed score tile of query rows r0.. (acc's rows) and key rows
// j0.. (its columns), split into w: s_ij exp(cum_i - cum_j) for i >= j
// inside the chunk, zero elsewhere, stored as w[i][j] or (trans) w[j][i].
__device__ __forceinline__ void write_scores(float* w, const Acc& s,
                                             const double* cum, int r0,
                                             int j0, int crow, bool trans) {
  const Lane L;
#pragma unroll
  for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
    for (int ej = 0; ej < 2; ++ej) {
      const int j = L.col(nj, ej), rj = j0 + j;
      const double cj = rj < crow ? cum[rj] : 0.0;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + ej, i = L.row(mi, e), ri = r0 + i;
          const float o = rj <= ri && ri < crow
                              ? s[mi][nj][e]
                                    * expf(static_cast<float>(cum[ri] - cj))
                              : 0.0f;
          const int at = trans ? j * kS + i : i * kS + j;
          const float hi = to_tf32(o);
          w[at] = hi;
          w[kPlane + at] = to_tf32(o - hi);
        }
    }
}

// Each row's dot product of acc with x's rows over the tile's columns
// below `width` (x through its strides), into red: a thread's columns in
// order, the row's four lanes by a butterfly, the four warps of a row
// added in warp order by out(m, sum) for m < rows.  Synchronises the
// block twice.
template <class Out>
__device__ __forceinline__ void row_dots(const Acc& acc, const float* x,
                                         long long s_row, long long s_col,
                                         int rows, int width, float* red,
                                         Out out) {
  const Lane L;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = L.row(mi, 2 * h);
      float part = 0.0f;
#pragma unroll
      for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = L.col(nj, e);
          if (m < rows && n < width)
            part = __fmaf_rn(x[m * s_row + n * s_col], acc[mi][nj][2 * h + e],
                             part);
        }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (L.t == 0) red[L.wn * kT + m] = part;
    }
  __syncthreads();
  if (threadIdx.x < rows) {
    float sum = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) sum = sum + red[w * kT + threadIdx.x];
    out(threadIdx.x, sum);
  }
  __syncthreads();
}

// acc's elements (m, n) for m < rows, n < width to or from out[m·s_m +
// n·s_n] (kLoad), each by the thread that holds it.
template <bool kLoad>
__device__ __forceinline__ void keep_sum(Acc& acc, float* out, size_t s_m,
                                         size_t s_n, int rows, int width) {
  const Lane L;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = L.row(mi, e), n = L.col(nj, e);
        if (m < rows && n < width) {
          float& x = out[m * s_m + n * s_n];
          if (kLoad)
            acc[mi][nj][e] = x;
          else
            x = acc[mi][nj][e];
        }
      }
}

// A dq partial in the workspace, thread-major: the 64 x 64 tile as each
// thread's accumulator elements in order (its past-the-edge ones zero),
// float4 stores and loads that a warp makes on 512 neighbouring bytes.
// dk/dv blocks store, dq-sum blocks (the same fragment layout) add.
constexpr int kPerThread = 2 * kNJ * 4;

__device__ __forceinline__ void store_part(const Acc& s, float* part) {
  float4* out = reinterpret_cast<float4*>(part + threadIdx.x * kPerThread);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
      out[mi * kNJ + nj] = make_float4(s[mi][nj][0], s[mi][nj][1],
                                       s[mi][nj][2], s[mi][nj][3]);
}

__device__ __forceinline__ void add_part(Acc& acc, const float* part) {
  const float4* in =
      reinterpret_cast<const float4*>(part + threadIdx.x * kPerThread);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj) {
      const float4 x = in[mi * kNJ + nj];
      acc[mi][nj][0] = acc[mi][nj][0] + x.x;
      acc[mi][nj][1] = acc[mi][nj][1] + x.y;
      acc[mi][nj][2] = acc[mi][nj][2] + x.z;
      acc[mi][nj][3] = acc[mi][nj][3] + x.w;
    }
}

// Each column's dot product of acc with x's rows, x[col·s_row + m·s_col]
// for the tile's rows m below `width` and columns below `cols` (x through
// its strides), into red: a thread's rows in order, the column's eight
// lanes by a butterfly, the two warps of a column added in warp order by
// out(col, sum).  Synchronises the block twice.
template <class Out>
__device__ __forceinline__ void col_dots(const Acc& acc, const float* x,
                                         long long s_row, long long s_col,
                                         int cols, int width, float* red,
                                         Out out) {
  const Lane L;
#pragma unroll
  for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = L.col(nj, e);
      float part = 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = L.row(mi, 2 * h);
          if (n < cols && m < width)
            part = __fmaf_rn(x[n * s_row + m * s_col], acc[mi][nj][2 * h + e],
                             part);
        }
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      part += __shfl_xor_sync(0xffffffffu, part, 8);
      part += __shfl_xor_sync(0xffffffffu, part, 16);
      if (L.g == 0) red[(L.m0 / 32) * kT + n] = part;
    }
  __syncthreads();
  if (threadIdx.x < cols)
    out(threadIdx.x, red[threadIdx.x] + red[kT + threadIdx.x]);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Phase 0: the chunks' cumsum and exp(total_c)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssm_bwd_cum_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw);
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  chunk_cumsum(cum, p.ld + b * p.sld[0] + h * p.sld[2] + c0 * p.sld[1],
               p.sld[1], crow);
  double* out = p.cum + (static_cast<size_t>(bh) * p.C + c) * p.chunk_pad;
  for (int r = threadIdx.x; r < crow; r += kThreads) out[r] = cum[r];
  if (threadIdx.x == 0)
    p.etot[bh * p.C + c] = expf(static_cast<float>(cum[crow - 1]));
}

// ---------------------------------------------------------------------------
// Phase 1: ΔG_c = Σ_i exp(cum_i) q_i dy_iᵀ, one 64 x 64 tile a block
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 2) ssm_bwd_dstate_kernel(
    Params p) {
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n0 = (blockIdx.z / p.n_p) * kT, p0 = (blockIdx.z % p.n_p) * kT;
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  const Tile t = load_chunk(p, bh, c, crow);
  for (int r = threadIdx.x; r < crow; r += kThreads)   // q's row factors
    t.gate[r] = expf(static_cast<float>(t.cum[r]));
  const Lane L;
  const float* qb = p.q + b * p.sq[0] + h * p.sq[2] + c0 * p.sq[1]
                    + n0 * p.sq[3];
  const float* db = p.dy + b * p.sdy[0] + h * p.sdy[2] + c0 * p.sdy[1]
                    + p0 * p.sdy[3];
  const int wn = min(kT, p.N - n0), wp = min(kT, p.P - p0);
  const bool live = L.m0 < wn && L.n0 < wp;
  // A[i][n] = e^cum_i q_i[n] (staged [i][n]), B[p][i] = dy_i[p].
  auto a = [&](int i0) {
    return Src{qb + i0 * p.sq[1], p.sq[1], p.sq[3], min(kT, crow - i0), wn,
               false, t.gate + i0};
  };
  auto bsrc = [&](int i0) {
    return Src{db + i0 * p.sdy[1], p.sdy[1], p.sdy[3], min(kT, crow - i0),
               wp, true, nullptr};
  };
  __syncthreads();
  t.prefetch(a(0), bsrc(0));
  Acc acc;
  zero(acc);
  for (int i0 = 0; i0 < crow; i0 += kT) {
    t.land(a(i0), bsrc(i0));
    if (i0 + kT < crow) t.prefetch(a(i0 + kT), bsrc(i0 + kT));
    if (live) mma_tile(acc, t.x, t.y, 0, round8(min(kT, crow - i0)));
  }
  float* out = p.gs + (static_cast<size_t>(bh) * p.C + c) * p.N * p.P;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = L.row(mi, e), col = L.col(nj, e);
        if (n < wn && col < wp)
          out[static_cast<size_t>(n0 + n) * p.P + p0 + col] = acc[mi][nj][e];
      }
}

// ---------------------------------------------------------------------------
// Phase 2: G_{c-1} = exp(total_c)·G_c + ΔG_c, from the last chunk back
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssm_bwd_state_pass_kernel(
    Params p) {
  const int bh = blockIdx.x;
  const size_t np = static_cast<size_t>(p.N) * p.P;
  const size_t e = static_cast<size_t>(blockIdx.y) * kThreads + threadIdx.x;
  if (e >= np) return;
  float gc = p.d_final != nullptr ? p.d_final[bh * np + e] : 0.0f;
  float* d = p.gs + static_cast<size_t>(bh) * p.C * np + e;
  const float* et = p.etot + bh * p.C;
  for (int c0 = p.C - 1; c0 >= 0; c0 -= kAhead) {
    float inc[kAhead];                      // ΔG of kAhead chunks, loaded
#pragma unroll                              // before any is overwritten
    for (int k = 0; k < kAhead; ++k)
      inc[k] = c0 - k >= 0 ? d[(c0 - k) * np] : 0.0f;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 - k;
      if (c >= 0) {
        d[c * np] = gc;                     // G_c, for phase 3
        gc = gc * et[c] + inc[k];
      }
    }
  }
  p.d_init[bh * np + e] = gc;
}

// ---------------------------------------------------------------------------
// Phase 2b: the carries, one column tile of one kind a block
// ---------------------------------------------------------------------------
// The terms of phase 3 that the state carries in or out of a chunk, each
// a product over P or N (grid z: kind, column tile), for each 64-row tile
// of the chunk in turn:
//   kind 0 (a chunk with a carry out): dk̃_j's, exp(total - cum_j) G_c v_j
//     (A = v_j staged [p][j], B = G_c [n][p]), into dk, unscaled;
//   kind 1 (likewise): dṽ_j's, held transposed, exp(total - cum_j) G_cᵀ
//     k_j (A = G_c [n][p], B = k_j [j][n]), into dv;
//   kind 2 (a chunk with an entering state): dq_i's, held transposed,
//     exp(cum_i) S_{c-1} dy_i (A = S_{c-1} [p][n], B = dy_i [i][p]), into
//     the diagonal pair's slot of the dq partials.
// Phase 3 starts its sums from them.  The steps, (row tile, slab) in
// order, each have the next one's copies in flight.
__global__ void __launch_bounds__(kThreads, 2) ssm_bwd_carry_kernel(
    Params p) {
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n_c = max(p.n_n, p.n_p);
  const int kind = blockIdx.z / n_c, ct = blockIdx.z % n_c;
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  const int width = kind == 1 ? p.P : p.N;  // the column tiles'
  const int depth = kind == 1 ? p.N : p.P;  // the products'
  if (ct * kT >= width) return;
  if (kind == 2 ? !(c > 0 || p.has_s0)
                : !(c < p.C - 1 || p.d_final != nullptr))
    return;
  const Tile t = load_chunk(p, bh, c, crow);
  const Lane L;
  const int col0 = ct * kT, wc = min(kT, width - col0);
  const int n_slab = cdiv(depth, kT), n_steps = cdiv(crow, kT) * n_slab;
  const float* gsb = p.gs + (static_cast<size_t>(bh) * p.C + c) * p.N * p.P;
  const float* sb = p.states
                    + (static_cast<size_t>(bh) * p.C + c) * p.N * p.P;
  const float* kb = p.k + b * p.sk[0] + h * p.sk[2] + c0 * p.sk[1];
  const float* vb = p.v + b * p.sv[0] + h * p.sv[2] + c0 * p.sv[1];
  const float* dyb = p.dy + b * p.sdy[0] + h * p.sdy[2] + c0 * p.sdy[1];
  const double total = t.cum[crow - 1];
  auto srcs = [&](int step, Src& a, Src& bs) {
    const int r0 = step / n_slab * kT, rows = min(kT, crow - r0);
    const int d0 = step % n_slab * kT, wk = min(kT, depth - d0);
    if (kind == 0) {
      a = Src{vb + r0 * p.sv[1] + d0 * p.sv[3], p.sv[1], p.sv[3], rows, wk,
              true, nullptr};
      bs = Src{gsb + static_cast<size_t>(col0) * p.P + d0, p.P, 1, wc, wk,
               false, nullptr};
    } else if (kind == 1) {
      a = Src{gsb + static_cast<size_t>(d0) * p.P + col0, p.P, 1, wk, wc,
              false, nullptr};
      bs = Src{kb + r0 * p.sk[1] + d0 * p.sk[3], p.sk[1], p.sk[3], rows, wk,
               false, nullptr};
    } else {
      a = Src{sb + static_cast<size_t>(col0) * p.P + d0, p.P, 1, wc, wk,
              true, nullptr};
      bs = Src{dyb + r0 * p.sdy[1] + d0 * p.sdy[3], p.sdy[1], p.sdy[3],
               rows, wk, false, nullptr};
    }
  };
  const bool live = kind == 0 ? L.n0 < wc : L.m0 < wc;
  Acc acc;
  zero(acc);
  Src a, bs;
  srcs(0, a, bs);
  t.prefetch(a, bs);
  for (int step = 0; step < n_steps; ++step) {
    srcs(step, a, bs);
    t.land(a, bs);
    if (step + 1 < n_steps) {
      Src na, nb;
      srcs(step + 1, na, nb);
      t.prefetch(na, nb);
    }
    const int tile = step / n_slab, d0 = step % n_slab * kT;
    if (live) mma_tile(acc, t.x, t.y, 0, round8(min(kT, depth - d0)));
    if (step % n_slab != n_slab - 1) continue;
    const int r0 = tile * kT, rows = min(kT, crow - r0);
    const size_t row0 = (static_cast<size_t>(b) * p.L + c0 + r0) * p.H + h;
    if (kind == 0) {
      scale_rows(acc, rows, [&](int m) {
        return expf(static_cast<float>(total - t.cum[r0 + m]));
      });
      keep_sum<false>(acc, p.dk + row0 * p.N + col0,
                      static_cast<size_t>(p.H) * p.N, 1, rows, wc);
    } else {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)        // columns: the rows of the chunk
#pragma unroll
        for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = L.col(nj, e);
            acc[mi][nj][e] *= j >= rows ? 0.0f
                : expf(static_cast<float>(kind == 1
                                              ? total - t.cum[r0 + j]
                                              : t.cum[r0 + j]));
          }
      if (kind == 1)
        keep_sum<false>(acc, p.dv + row0 * p.P + col0, 1,
                        static_cast<size_t>(p.H) * p.P, wc, rows);
      else
        store_part(acc, p.dqp + ((((static_cast<size_t>(bh) * p.C + c)
                                   * p.pairs + tile * (tile + 1) / 2 + tile)
                                  * p.n_n + ct) * kT * kT));
    }
    zero(acc);
  }
}

// ---------------------------------------------------------------------------
// Phase 3: per key tile, dk̃ and the dq partials (even z) or dṽ (odd z)
// ---------------------------------------------------------------------------
// A block's staged steps, in order: for each query tile i from the key
// tile j on, the score slabs (stage 0, over P for dk̃, N for dṽ), then
// each column tile's products (stage 2, of N for dk̃, of P for dṽ).  Each
// step stages its operands in place.
struct Step {
  int qt, stage, col, slab;
  bool done;
};

__device__ __forceinline__ Step next_step(Step s, int last, int n_slab,
                                          int n_col) {
  if (s.stage == 0) {
    if (++s.slab < n_slab) return s;
    s.slab = 0;
    s.stage = 2;
  } else if (++s.col == n_col) {
    s.col = 0;
    s.stage = 0;
    s.done = ++s.qt > last;
  }
  return s;
}

// One key tile's dk̃ and the dq partials of every (query tile, this key
// tile) pair.  For each query tile i >= j: the scores S = dy_i·v_jᵀ (A =
// dy staged [p][i], B = v [j][p]) decayed into W, stored [i][j]; then for
// each 64-column tile of N, dk̃[j][n] += Σ_i W[i][j] q_i[n] (A = W, B = q
// staged [n][i]) and the partial dq_i(j)ᵀ[n][i] = Σ_j (g k)_j[n] W[i][j]
// (A = g k staged [j][n], B = W) into the workspace.  dk̃ starts from its
// carry (phase 2b's, in dk), the diagonal pair's partial from dq's carry
// (in its slot).  At the last query tile dk = g·dk̃ and k·dk̃'s slot.
__device__ __forceinline__ void dk_tile(const Params& p, const Tile& t,
                                        int bh, int c, int kt, int crow) {
  const Lane L;
  const int b = bh / p.H, h = bh % p.H;
  const int c0 = c * p.chunk, j0 = kt * kT, rows_k = min(kT, crow - j0);
  const int last = cdiv(crow, kT) - 1, n_slab = cdiv(p.P, kT);
  const float* kb = p.k + b * p.sk[0] + h * p.sk[2] + (c0 + j0) * p.sk[1];
  const float* vb = p.v + b * p.sv[0] + h * p.sv[2] + (c0 + j0) * p.sv[1];
  const float* qb = p.q + b * p.sq[0] + h * p.sq[2] + c0 * p.sq[1];
  const float* dyb = p.dy + b * p.sdy[0] + h * p.sdy[2] + c0 * p.sdy[1];
  const bool carry = c < p.C - 1 || p.d_final != nullptr;
  const bool q_carry = c > 0 || p.has_s0;
  const size_t row0 = (static_cast<size_t>(b) * p.L + c0 + j0) * p.H + h;
  float* dkb = p.dk + row0 * p.N;
  const size_t ld = static_cast<size_t>(p.H) * p.N;
  Acc acc, s;                               // dk̃ of a column tile; scores,
  for (Step cur{kt, 0, 0, 0, false}; !cur.done;  // then dq_i(j)ᵀ
       cur = next_step(cur, last, n_slab, p.n_n)) {
    const int r0 = cur.qt * kT, rows_q = min(kT, crow - r0);
    const bool diag = cur.qt == kt;
    const int col0 = cur.col * kT, wc = min(kT, p.N - col0);
    if (cur.stage == 0) {                   // s = dy_i·v_jᵀ over P
      const int p0 = cur.slab * kT, wk = min(kT, p.P - p0);
      t.land(Src{dyb + r0 * p.sdy[1] + p0 * p.sdy[3], p.sdy[1], p.sdy[3],
                 rows_q, wk, true, nullptr},
             Src{vb + p0 * p.sv[3], p.sv[1], p.sv[3], rows_k, wk, false,
                 nullptr});
      if (cur.slab == 0) zero(s);
      if (!diag || L.n0 < L.m0 + 32) mma_tile(s, t.x, t.y, 0, round8(wk));
      if (cur.slab == n_slab - 1)
        write_scores(t.w, s, t.cum, r0, j0, crow, false);
      continue;
    }
    t.land(Src{qb + r0 * p.sq[1] + col0 * p.sq[3], p.sq[1], p.sq[3], rows_q,
               wc, true, nullptr},
           Src{kb + col0 * p.sk[3], p.sk[1], p.sk[3], rows_k, wc, false,
               t.gate + j0});
    if (diag ? carry : p.n_n > 1)
      keep_sum<true>(acc, dkb + col0, ld, 1, rows_k, wc);
    else if (diag)
      zero(acc);
    if (L.n0 < wc)                          // dk̃ += Wᵀ·q_i: i >= j
      mma_tile(acc, t.w, t.x, diag ? L.m0 : 0, round8(rows_q));
    float* part = p.dqp + ((((static_cast<size_t>(bh) * p.C + c) * p.pairs
                             + cur.qt * (cur.qt + 1) / 2 + kt) * p.n_n
                            + cur.col) * kT * kT);
    zero(s);
    if (diag && q_carry) add_part(s, part);
    if (L.m0 < wc)                          // dq_i(j)ᵀ = (g k)_jᵀ Wᵀ: j <= i
      mma_tile(s, t.y, t.w, 0, diag ? min(round8(rows_k), L.n0 + 16)
                                    : round8(rows_k));
    store_part(s, part);
    if (cur.qt == last) {                   // dk = g·dk̃ and k·dk̃
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = L.row(mi, e), n = L.col(nj, e);
            if (m < rows_k && n < wc)
              dkb[m * ld + col0 + n] = t.gate[j0 + m] * acc[mi][nj][e];
          }
      row_dots(acc, kb + col0 * p.sk[3], p.sk[1], p.sk[3], rows_k, wc,
               t.red, [&](int m, float sum) {
                 p.kdk[(static_cast<size_t>(cur.col) * p.B * p.H + bh) * p.L
                       + c0 + j0 + m] = sum;
               });
    } else if (p.n_n > 1) {
      keep_sum<false>(acc, dkb + col0, ld, 1, rows_k, wc);
    }
  }
}

// One key tile's dṽ, its transpose held: for each query tile i >= j, the
// scores q_i·k_jᵀ (A = q staged [n][i], B = k [j][n]) decayed into W',
// stored [j][i]; then for each 64-column tile of P, dṽᵀ[p][j] += Σ_i
// dy_i[p] W'[i][j] (A = dy [i][p], B = W'), from its carry (phase 2b's,
// in dv); at the last query tile dv = g·dṽ.  Where N is one slab, k_j
// stays staged in y from the block's first step on.
__device__ __forceinline__ void dv_tile(const Params& p, const Tile& t,
                                        int bh, int c, int kt, int crow) {
  const Lane L;
  const int b = bh / p.H, h = bh % p.H;
  const int c0 = c * p.chunk, j0 = kt * kT, rows_k = min(kT, crow - j0);
  const int last = cdiv(crow, kT) - 1, n_slab = cdiv(p.N, kT);
  const float* kb = p.k + b * p.sk[0] + h * p.sk[2] + (c0 + j0) * p.sk[1];
  const float* qb = p.q + b * p.sq[0] + h * p.sq[2] + c0 * p.sq[1];
  const float* dyb = p.dy + b * p.sdy[0] + h * p.sdy[2] + c0 * p.sdy[1];
  const bool carry = c < p.C - 1 || p.d_final != nullptr;
  const size_t row0 = (static_cast<size_t>(b) * p.L + c0 + j0) * p.H + h;
  float* dvb = p.dv + row0 * p.P;
  const size_t ld = static_cast<size_t>(p.H) * p.P;
  Acc acc, s;                               // dṽᵀ of a column tile; scores
  for (Step cur{kt, 0, 0, 0, false}; !cur.done;
       cur = next_step(cur, last, n_slab, p.n_p)) {
    const int r0 = cur.qt * kT, rows_q = min(kT, crow - r0);
    const bool diag = cur.qt == kt;
    const int col0 = cur.col * kT, wc = min(kT, p.P - col0);
    if (cur.stage == 0) {                   // s = q_i·k_jᵀ over N
      const int n0 = cur.slab * kT, wk = min(kT, p.N - n0);
      const bool keep_k = n_slab == 1 && !diag;
      t.land(Src{qb + r0 * p.sq[1] + n0 * p.sq[3], p.sq[1], p.sq[3], rows_q,
                 wk, true, nullptr},
             Src{keep_k ? nullptr : kb + n0 * p.sk[3], p.sk[1], p.sk[3],
                 rows_k, wk, false, nullptr});
      if (cur.slab == 0) zero(s);
      if (!diag || L.n0 < L.m0 + 32) mma_tile(s, t.x, t.y, 0, round8(wk));
      if (cur.slab == n_slab - 1)
        write_scores(t.w, s, t.cum, r0, j0, crow, true);
      continue;
    }
    t.land(Src{dyb + r0 * p.sdy[1] + col0 * p.sdy[3], p.sdy[1], p.sdy[3],
               rows_q, wc, false, nullptr},
           Src{nullptr, 0, 0, 0, 0, false, nullptr});
    if (diag ? carry : p.n_p > 1)
      keep_sum<true>(acc, dvb + col0, 1, ld, wc, rows_k);
    else if (diag)
      zero(acc);
    if (L.m0 < wc)                          // dṽᵀ += dy_iᵀ W': i >= j
      mma_tile(acc, t.x, t.w, diag ? L.n0 : 0, round8(rows_q));
    if (cur.qt == last) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int pc = L.row(mi, e), j = L.col(nj, e);
            if (j < rows_k && pc < wc)
              dvb[j * ld + col0 + pc] = t.gate[j0 + j] * acc[mi][nj][e];
          }
    } else if (p.n_p > 1) {
      keep_sum<false>(acc, dvb + col0, 1, ld, wc, rows_k);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) ssm_bwd_dkdv_kernel(
    Params p) {
  const int bh = blockIdx.x, c = blockIdx.y, kt = blockIdx.z / 2;
  const int crow = min(p.chunk, p.L - c * p.chunk);
  if (kt * kT >= crow) return;
  const Tile t = load_chunk(p, bh, c, crow, true);
  if (blockIdx.z % 2 == 0)
    dk_tile(p, t, bh, c, kt, crow);
  else
    dv_tile(p, t, bh, c, kt, crow);
}

// ---------------------------------------------------------------------------
// Phase 3b: dq_i = Σ_{j<=i} dq_i(j) (the diagonal pair's partial holds the
// carry exp(cum_i) S_{c-1} dy_i) and q·dq's slot, a 64 x 64 tile a block
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssm_bwd_dq_sum_kernel(Params p) {
  __shared__ float red[2 * kT];
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int qt = p.n_q - 1 - static_cast<int>(blockIdx.z) / p.n_n;
  const int nt = blockIdx.z % p.n_n;
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  const int r0 = qt * kT;
  if (r0 >= crow) return;
  const Lane L;
  const int rows_q = min(kT, crow - r0);
  const int col0 = nt * kT, wc = min(kT, p.N - col0);
  Acc acc;                                  // dq_iᵀ[n][i], as the partials
  zero(acc);
  const float* part = p.dqp + ((static_cast<size_t>(bh) * p.C + c) * p.pairs
                               + qt * (qt + 1) / 2) * p.n_n * kT * kT
                      + static_cast<size_t>(nt) * kT * kT;
  for (int kt = 0; kt <= qt; ++kt)          // in ascending key tile
    add_part(acc, part + static_cast<size_t>(kt) * p.n_n * kT * kT);
  const size_t ld = static_cast<size_t>(p.H) * p.N;
  float* dqb = p.dq + ((static_cast<size_t>(b) * p.L + c0 + r0) * p.H + h)
                          * p.N + col0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < kNJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = L.row(mi, e), i = L.col(nj, e);
        if (i < rows_q && n < wc) dqb[i * ld + n] = acc[mi][nj][e];
      }
  const float* qb = p.q + b * p.sq[0] + h * p.sq[2] + (c0 + r0) * p.sq[1]
                    + col0 * p.sq[3];
  col_dots(acc, qb, p.sq[1], p.sq[3], rows_q, wc, red,
           [&](int i, float sum) {
             p.qdq[(static_cast<size_t>(nt) * p.B * p.H + bh) * p.L + c0 + r0
                   + i] = sum;
           });
}

// ---------------------------------------------------------------------------
// Phase 4: dg, d cum and its reverse cumsum d log_decay, one block a head
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) ssm_bwd_dlog_kernel(Params p) {
  __shared__ double buf[kPiece];
  __shared__ double red[kThreads];
  __shared__ double carry;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int n_n = cdiv(p.N, kT);
  const size_t np = static_cast<size_t>(p.N) * p.P;
  // <S_final, dS_final>: strided partial sums, then a fixed tree.
  double sf = 0.0;
  if (p.d_final != nullptr)
    for (size_t e = threadIdx.x; e < np; e += kThreads)
      sf += static_cast<double>(p.s_final[bh * np + e])
            * static_cast<double>(p.d_final[bh * np + e]);
  red[threadIdx.x] = sf;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) red[threadIdx.x] += red[threadIdx.x + o];
    __syncthreads();
  }
  const double sfds = red[0];
  if (threadIdx.x == 0) carry = 0.0;
  const size_t tile = static_cast<size_t>(p.B) * p.H * p.L;
  for (int hi = p.L; hi > 0; hi -= kPiece) {  // pieces from the end
    const int lo = max(0, hi - kPiece), n = hi - lo;
    for (int m = lo + threadIdx.x; m < hi; m += kThreads) {
      const size_t at = static_cast<size_t>(bh) * p.L + m;
      double dgv = 0.0, qdq = 0.0;
      for (int z = 0; z < n_n; ++z) {
        dgv += static_cast<double>(p.kdk[z * tile + at]);
        qdq += static_cast<double>(p.qdq[z * tile + at]);
      }
      const float gm = p.g[b * p.sg[0] + m * p.sg[1] + h * p.sg[2]];
      const size_t out = (static_cast<size_t>(b) * p.L + m) * p.H + h;
      p.dg[out] = static_cast<float>(dgv);
      buf[m - lo] = qdq - static_cast<double>(gm) * dgv
                    + (m == p.L - 1 ? sfds : 0.0);
    }
    __syncthreads();
    if (threadIdx.x < 32) {                   // one warp: 32 runs, from the end
      const int lane = threadIdx.x;
      const int seg = (n + 31) / 32;
      const int a = min(lane * seg, n), e = min(a + seg, n);
      double run = 0.0;
      for (int r = e - 1; r >= a; --r) {
        run += buf[r];
        buf[r] = run;
      }
      double incl = run;                      // the runs from this lane on
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double dn = __shfl_down_sync(0xffffffffu, incl, o);
        if (lane + o < 32) incl += dn;
      }
      double after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.0;
      const double base = carry;
      for (int r = a; r < e; ++r) buf[r] += after + base;
      const double piece = __shfl_sync(0xffffffffu, incl, 0);
      __syncwarp();
      if (lane == 0) carry = base + piece;
    }
    __syncthreads();
    for (int m = lo + threadIdx.x; m < hi; m += kThreads)
      p.dld[(static_cast<size_t>(b) * p.L + m) * p.H + h] =
          static_cast<float>(buf[m - lo]);
    __syncthreads();
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// The plan of kernel.plan_bwd, computed again from the shapes: tile,
// threads, query tiles a chunk, N tiles, P tiles, (query, key) tile pairs
// a chunk, the shared bytes of phases 1, 3 and 3b, and the dq partials'
// workspace in floats.
constexpr int kPlanLen = 10;

void plan_of(const Params& p, long long (&out)[kPlanLen]) {
  const long long ws = static_cast<long long>(p.B) * p.H * p.C * p.pairs
                       * p.n_n * kT * kT;
  const long long v[kPlanLen] = {
      kT, kThreads, p.n_q, p.n_n, p.n_p, p.pairs,
      static_cast<long long>(tile_smem(p.chunk_pad, false)),
      static_cast<long long>(tile_smem(p.chunk_pad, true)),
      2 * kT * 4, ws};
  for (int i = 0; i < kPlanLen; ++i) out[i] = v[i];
}

// phases: bit 0 cumsum, 1 chunk d-state, 2 reverse pass, 3 the carries,
// 4 dk/dv with the dq partials, 5 the dq sum, 6 d log_decay (127 for the
// function; one bit alone times that kernel on the scratch as it is).
int launch(const Params& p, int phases, cudaStream_t stream) {
  const size_t sm2 = tile_smem(p.chunk_pad, false);
  const size_t sm3 = tile_smem(p.chunk_pad, true);
  const size_t sm0 = 8 * static_cast<size_t>(p.chunk_pad);
  if (sm3 > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int e = set_smem(ssm_bwd_cum_kernel, sm0);
  if (!e) e = set_smem(ssm_bwd_dstate_kernel, sm2);
  if (!e) e = set_smem(ssm_bwd_carry_kernel, sm2);
  if (!e) e = set_smem(ssm_bwd_dkdv_kernel, sm3);
  if (e) return e;
  const unsigned bh = static_cast<unsigned>(p.B * p.H);
  const int np = p.N * p.P;
  if (phases & 1)
    ssm_bwd_cum_kernel<<<dim3(bh, p.C), kThreads, sm0, stream>>>(p);
  if (phases & 2)
    ssm_bwd_dstate_kernel<<<dim3(bh, p.C, p.n_n * p.n_p), kThreads, sm2,
                            stream>>>(p);
  if (phases & 4)
    ssm_bwd_state_pass_kernel<<<dim3(bh, cdiv(np, kThreads)), kThreads, 0,
                                stream>>>(p);
  if (phases & 8)
    ssm_bwd_carry_kernel<<<dim3(bh, p.C, 3 * max(p.n_n, p.n_p)), kThreads,
                           sm2, stream>>>(p);
  if (phases & 16)
    ssm_bwd_dkdv_kernel<<<dim3(bh, p.C, p.n_q * 2), kThreads, sm3,
                          stream>>>(p);
  if (phases & 32)
    ssm_bwd_dq_sum_kernel<<<dim3(bh, p.C, p.n_q * p.n_n), kThreads, 0,
                            stream>>>(p);
  if (phases & 64)
    ssm_bwd_dlog_kernel<<<bh, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the backward's kernels on `stream`; returns the first CUDA error
// (0 on success), or cudaErrorInvalidValue for a shape the kernels do not
// take (an empty input, chunk outside [1, L], more than 65535 chunks, or
// more shared memory than a block may have) or a `plan` other than the
// one the shapes give (kernel.plan_bwd's, kPlanLen values).  All float32.
// `strides` (host memory, in elements): k's four, q's four, v's four,
// dy's four, log_decay's three and gate's three.  d_final [B, H, N, P]
// contiguous or null; states [B, H, C, N, P] (S_{c-1}, the forward's
// scratch) and s_final [B, H, N, P] contiguous; dk, dq [B, L, H, N], dv
// [B, L, H, P], dld, dg [B, L, H] and d_init [B, H, N, P] contiguous
// outputs; gs [B, H, C, N, P], cum [B, H, C, chunk_pad] (float64), etot
// [B, H, C], qdq, kdk [N tiles, B, H, L] and dqp [B, H, C, pairs, N tiles,
// 64 x 64, thread-major] scratch, C = ceil(L / chunk), chunk_pad = chunk
// rounded up to a multiple of 64, N tiles = ceil(N / 64), pairs = q(q +
// 1)/2 for q = chunk_pad / 64.  has_s0: the forward had an initial state
// (else S_{-1} = 0 and chunk 0 skips its carry).
extern "C" int ssm_scan_bwd_launch(
    const void* k, const void* q, const void* v, const void* ld,
    const void* g, const void* dy, const void* d_final, const void* states,
    const void* s_final, void* dk, void* dq, void* dv, void* dld, void* dg,
    void* d_init, void* gs, void* cum, void* etot, void* qdq, void* kdk,
    void* dqp, const long long* strides, const long long* plan, int has_s0,
    int B, int L, int H, int N, int P, int chunk, int phases, void* stream) {
  if (B < 1 || L < 1 || H < 1 || N < 1 || P < 1 || chunk < 1 || chunk > L)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.k = static_cast<const float*>(k);
  p.q = static_cast<const float*>(q);
  p.v = static_cast<const float*>(v);
  p.dy = static_cast<const float*>(dy);
  p.ld = static_cast<const float*>(ld);
  p.g = static_cast<const float*>(g);
  p.d_final = static_cast<const float*>(d_final);
  p.states = static_cast<const float*>(states);
  p.s_final = static_cast<const float*>(s_final);
  p.dk = static_cast<float*>(dk);
  p.dq = static_cast<float*>(dq);
  p.dv = static_cast<float*>(dv);
  p.dld = static_cast<float*>(dld);
  p.dg = static_cast<float*>(dg);
  p.d_init = static_cast<float*>(d_init);
  p.gs = static_cast<float*>(gs);
  p.cum = static_cast<double*>(cum);
  p.etot = static_cast<float*>(etot);
  p.qdq = static_cast<float*>(qdq);
  p.kdk = static_cast<float*>(kdk);
  p.dqp = static_cast<float*>(dqp);
  for (int i = 0; i < 4; ++i) {
    p.sk[i] = strides[i];
    p.sq[i] = strides[4 + i];
    p.sv[i] = strides[8 + i];
    p.sdy[i] = strides[12 + i];
  }
  for (int i = 0; i < 3; ++i) {
    p.sld[i] = strides[16 + i];
    p.sg[i] = strides[19 + i];
  }
  p.B = B;
  p.L = L;
  p.H = H;
  p.N = N;
  p.P = P;
  p.chunk = chunk;
  p.C = (L + chunk - 1) / chunk;
  p.chunk_pad = (chunk + kT - 1) / kT * kT;
  p.has_s0 = has_s0;
  p.n_q = p.chunk_pad / kT;
  p.n_n = cdiv(N, kT);
  p.n_p = cdiv(P, kT);
  p.pairs = p.n_q * (p.n_q + 1) / 2;
  if (p.C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  long long want[kPlanLen];
  plan_of(p, want);
  for (int i = 0; i < kPlanLen; ++i)
    if (plan == nullptr || plan[i] != want[i])
      return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, phases, static_cast<cudaStream_t>(stream));
}

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
//   3. chunk backward, two kernels:
//        dq_i  = Σ_{j<=i} (dy_i·v_j) exp(cum_i - cum_j) g_j k_j
//                + exp(cum_i) S_{c-1} dy_i,
//        dk̃_j = Σ_{i>=j} (dy_i·v_j) exp(cum_i - cum_j) q_i
//                + exp(total - cum_j) G_c v_j,
//        dṽ_j = Σ_{i>=j} (q_i·k_j) exp(cum_i - cum_j) dy_i
//                + exp(total - cum_j) G_cᵀ k_j,
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
// Determinism: no atomics.  A sum split over blocks (the dot products over
// N's tiles in phase 4) goes to a workspace, one slot a tile, and phase 4
// adds the slots in tile order.  The split comes from the shapes alone.
// Every other sum is one thread's, in a fixed order, or a butterfly over a
// fixed set of lanes: two runs are bitwise equal.
//
// Precision: float32 products on the CUDA cores (explicit fmaf; the build
// contracts nothing else), float32 accumulators.  cum is summed in float64
// (the forward's order), and each decay exponent is taken in float64 and
// rounded once before expf, as the forward does.  Phase 4 sums the partial
// dot products and runs the L-long reverse cumsum in float64: d cum is a
// difference of two large dot products, and a float32 running sum over L
// positions would add a rounding of the running magnitude at each step.
//
// Bound on the H100: operations, at least the smaller of the chunked
// form's and the recurrence's counts against 67 TFLOP/s of float32 outside
// the tensor cores; chip_smoke.py prints both from the call's shapes.
// Design, 256 threads a block, each thread a 4 x 4 piece of a 64 x 64
// output tile, operands staged in shared memory in 32-deep slabs, two in
// flight by `cp.async` (phase 1 scales each q slab in place once it has
// landed):
// - phase 1, grid (B·H, C, N tiles x P tiles): a 64 x 64 tile of ΔG_c;
// - phase 2, grid (B·H, N·P / 256): one element of the state a thread,
//   its ΔG of eight chunks loaded at a time;
// - phase 3a, grid (B·H, C, query tiles), heaviest first: 64 rows of dq,
//   every 64-column tile of N in turn;
// - phase 3b, grid (B·H, C, key tiles x 2), heaviest first: 64 rows of dk
//   (scores dy·vᵀ, then Σ_i over q) or of dv (scores q·kᵀ, then Σ_i over
//   dy), every 64-column tile of N or P in turn;
// - phase 4, grid (B·H): one block a head walks L from the end in pieces of
//   2048 positions, one warp scanning each piece.
// In phase 3 a block computes each 64 x 64 tile of decayed scores once and
// keeps the chunk's score tiles in shared memory for its column tiles (dq
// at N <= 64 reuses one tile).
//
// The forward's split-TF32 `mma.sync` tiles did not carry over, and the
// backward runs in plain float32 on the CUDA cores.  Phase 1 is the
// forward's chunk-state product with another row weight (exp(cum_i) for
// g_j·exp(total - cum_j)); the forward's kernel forms its weight inside
// from log_decay and gate, so taking it over means a new template mode of
// the serving path's kernel.  The dq, dk̃ and dṽ products contract the
// score tile over its query or key index (Wᵀ·Y and W·Y with W anti-causal
// or causal, staged in shared memory), which the forward's chunk-scan
// fragments (causal W·V with W in registers) do not lay out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;              // rows and columns of an output tile
constexpr int kKS = 32;             // depth of a staged slab
constexpr int kLd = kT + 4;         // shared row stride (floats) of a slab
constexpr int kSlab = kKS * kLd;    // floats of a slab
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
  long long sk[4], sq[4], sv[4], sdy[4], sld[3], sg[3];
  int B, L, H, N, P, chunk, C, chunk_pad, has_s0;
};

__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One asynchronous 4-byte copy into shared memory; `valid` 0 zero-fills.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// dst[kk][r] = x[r][d0 + kk] for r < 64, kk < kKS (zero where r >= rows or
// d0 + kk >= width): a 64-row operand, its depth along x's columns, copied
// asynchronously.  A thread copies one column kk, every eighth row.
__device__ __forceinline__ void stage_t(float* dst, const float* x,
                                        long long s_row, long long s_col,
                                        int rows, int width, int d0) {
  constexpr int kStep = kThreads / kKS;
  const int kk = threadIdx.x % kKS, r0 = threadIdx.x / kKS;
  const bool col_ok = d0 + kk < width;
  const float* src = x + r0 * s_row + (d0 + kk) * s_col;
  dst += kk * kLd + r0;
#pragma unroll 1
  for (int r = r0; r < kT; r += kStep) {
    const bool ok = col_ok && r < rows;
    cp_async4(dst, ok ? src : x, ok);
    src += kStep * s_row;
    dst += kStep;
  }
}

// dst[kk][c] = x[kk][c] for kk < kKS, c < 64 (zero where kk >= rows or c >=
// width): a 64-column operand, its depth along x's rows, copied
// asynchronously.  A thread copies one column c, every fourth row.
__device__ __forceinline__ void stage_n(float* dst, const float* x,
                                        long long s_row, long long s_col,
                                        int rows, int width) {
  constexpr int kStep = kThreads / kT;
  const int c = threadIdx.x % kT, kk0 = threadIdx.x / kT;
  const bool col_ok = c < width;
  const float* src = x + kk0 * s_row + c * s_col;
  dst += kk0 * kLd + c;
#pragma unroll 1
  for (int kk = kk0; kk < kKS; kk += kStep) {
    const bool ok = col_ok && kk < rows;
    cp_async4(dst, ok ? src : x, ok);
    src += kStep * s_row;
    dst += kStep * kLd;
  }
}

// acc[i][j] += Σ_kk a[kk][4 ty + i] · b[kk][4 tx + j] over kKS steps, in
// order: thread (ty, tx) = (tid / 16, tid % 16) holds rows 4 ty .. 4 ty + 3
// and columns 4 tx .. 4 tx + 3 of the 64 x 64 tile.
__device__ __forceinline__ void mac(float (&acc)[4][4], const float* a,
                                    const float* b) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int kk = 0; kk < kKS; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(a + kk * kLd + 4 * ty);
    const float4 bv = *reinterpret_cast<const float4*>(b + kk * kLd + 4 * tx);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
  }
}

// Slabs 0 .. n-1 of a product, two in flight: stage(s, buf) issues slab
// s's asynchronous copies into ring buffer buf, and step(s, buf) adds it
// into the accumulators once it has landed, while slab s + 1 copies.
template <class Stage, class Step>
__device__ __forceinline__ void pipeline(int n, Stage stage, Step step) {
  stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < n; ++s) {
    if (s + 1 < n) stage(s + 1, (s + 1) & 1);
    cp_async_commit();                      // an empty group keeps the count
    cp_async_wait1();
    __syncthreads();
    step(s, s & 1);
    __syncthreads();
  }
}

// acc += X Yᵀ over a depth of `width`: X's rows [rx, 64) and Y's [ry, 64)
// (row strides, column strides), both staged through the rings a and b.
__device__ __forceinline__ void mac_nt(float (&acc)[4][4], float* a, float* b,
                                       const float* x, long long sx_r,
                                       long long sx_c, int rx, const float* y,
                                       long long sy_r, long long sy_c, int ry,
                                       int width) {
  pipeline(
      cdiv(width, kKS),
      [&](int s, int buf) {
        stage_t(a + buf * kSlab, x, sx_r, sx_c, rx, width, s * kKS);
        stage_t(b + buf * kSlab, y, sy_r, sy_c, ry, width, s * kKS);
      },
      [&](int, int buf) { mac(acc, a + buf * kSlab, b + buf * kSlab); });
}

// acc[i][c] += Σ_j w[j][i] y[j][c] over 64 depth rows j: w a 64 x 64 tile
// in shared memory, its depth first (w[j * kLd + i]); y's rows j < rows
// and columns c < width staged through the ring b, 32 rows at a time.
__device__ __forceinline__ void mac_wn(float (&acc)[4][4], const float* w,
                                       float* b, const float* y,
                                       long long s_r, long long s_c, int rows,
                                       int width) {
  pipeline(
      kT / kKS,
      [&](int s, int buf) {
        stage_n(b + buf * kSlab, y + s * kKS * s_r, s_r, s_c,
                rows - s * kKS, width);
      },
      [&](int s, int buf) { mac(acc, w + s * kKS * kLd, b + buf * kSlab); });
}

// The sum of `part` over the 16 threads that share a tile row (lanes tx =
// 0..15 of one half warp), a butterfly in a fixed order.
__device__ __forceinline__ float row_sum16(float part) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, o);
  return part;
}

// Shared memory of phases 1 and 3: the chunk's cum (float64) and gate,
// two rings of two slabs and `slots` 64 x 64 score tiles.
__host__ __device__ inline size_t tile_smem(int chunk_pad, int slots) {
  return 12 * static_cast<size_t>(chunk_pad) + 4 * kSlab * 4
         + static_cast<size_t>(slots) * kT * kLd * 4;
}

struct Tile {
  double* cum;
  float* gate;
  float* a;                         // a ring of two slabs
  float* b;                         // a ring of two slabs
  float* w;                         // score tiles, 64 x kLd floats each
};

// Carves the shared memory and loads the chunk's cum (phase 0's) and gate.
__device__ Tile load_chunk(const Params& p, int bh, int c, int crow) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tile t;
  t.cum = reinterpret_cast<double*>(smem_raw);
  t.gate = reinterpret_cast<float*>(t.cum + p.chunk_pad);
  t.a = t.gate + p.chunk_pad;
  t.b = t.a + 2 * kSlab;
  t.w = t.b + 2 * kSlab;
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
__global__ void __launch_bounds__(kThreads) ssm_bwd_dstate_kernel(Params p) {
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n_p = cdiv(p.P, kT);
  const int n0 = (blockIdx.z / n_p) * kT, p0 = (blockIdx.z % n_p) * kT;
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  const Tile t = load_chunk(p, bh, c, crow);
  const float* qb = p.q + b * p.sq[0] + h * p.sq[2] + c0 * p.sq[1]
                    + n0 * p.sq[3];
  const float* db = p.dy + b * p.sdy[0] + h * p.sdy[2] + c0 * p.sdy[1]
                    + p0 * p.sdy[3];
  const int wn = min(kT, p.N - n0), wp = min(kT, p.P - p0);
  float acc[4][4] = {};
  pipeline(
      cdiv(crow, kKS),
      [&](int s, int buf) {
        const int i0 = s * kKS, rows = min(kKS, crow - i0);
        stage_n(t.a + buf * kSlab, qb + i0 * p.sq[1], p.sq[1], p.sq[3], rows,
                wn);
        stage_n(t.b + buf * kSlab, db + i0 * p.sdy[1], p.sdy[1], p.sdy[3],
                rows, wp);
      },
      [&](int s, int buf) {                 // q's rows times exp(cum_i)
        float* a = t.a + buf * kSlab;
        for (int i = threadIdx.x; i < kT * kKS; i += kThreads) {
          const int col = i % kT, kk = i / kT, r = s * kKS + kk;
          if (r < crow && col < wn)
            a[kk * kLd + col] *= expf(static_cast<float>(t.cum[r]));
        }
        __syncthreads();
        mac(acc, a, t.b + buf * kSlab);
      });
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* out = p.gs + (static_cast<size_t>(bh) * p.C + c) * p.N * p.P;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * ty + i, col = p0 + 4 * tx + j;
      if (n < p.N && col < p.P)
        out[static_cast<size_t>(n) * p.P + col] = acc[i][j];
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
// Phase 3a: dq for 64 rows of a chunk, every 64-column tile of N in turn.
// kMulti: N spans more than one tile, and the block computes the score
// tile of each key tile first, into shared memory, then walks N's tiles;
// else N <= 64, one score tile is reused and the walk is compiled away
// (less shared memory: more blocks an SM).
// ---------------------------------------------------------------------------
template <bool kMulti>
__global__ void __launch_bounds__(kThreads) ssm_bwd_dq_kernel(Params p) {
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int n_n = kMulti ? cdiv(p.N, kT) : 1, n_q = cdiv(p.chunk, kT);
  const int qt = n_q - 1 - static_cast<int>(blockIdx.z);
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  const int r0 = qt * kT;
  if (r0 >= crow) return;
  const Tile t = load_chunk(p, bh, c, crow);
  const int rows_q = min(kT, crow - r0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* dyb = p.dy + b * p.sdy[0] + h * p.sdy[2]
                     + (c0 + r0) * p.sdy[1];
  const float* qb = p.q + b * p.sq[0] + h * p.sq[2] + (c0 + r0) * p.sq[1];
  // The decayed, gated scores (dy_i·v_j) exp(cum_i - cum_j) g_j of key
  // tile kt into the score tile w, its depth (j) first.
  auto scores = [&](int kt, float* w) {
    const int j0 = kt * kT, rows_k = min(kT, crow - j0);
    const float* vb = p.v + b * p.sv[0] + h * p.sv[2] + (c0 + j0) * p.sv[1];
    float s[4][4] = {};
    mac_nt(s, t.a, t.b, dyb, p.sdy[1], p.sdy[3], rows_q, vb, p.sv[1],
           p.sv[3], rows_k, p.P);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ri = r0 + 4 * ty + i, rj = j0 + 4 * tx + j;
        w[(4 * tx + j) * kLd + 4 * ty + i] =
            rj <= ri && ri < crow
                ? s[i][j] * expf(static_cast<float>(t.cum[ri] - t.cum[rj]))
                      * t.gate[rj]
                : 0.0f;
      }
  };
  if (kMulti)                               // every key tile's, first
    for (int kt = 0; kt <= qt; ++kt) scores(kt, t.w + kt * kT * kLd);
  for (int nt = 0; nt < n_n; ++nt) {
    const int n0 = nt * kT, wn = min(kT, p.N - n0);
    float acc[4][4] = {};
    if (c > 0 || p.has_s0) {                // exp(cum_i) S_{c-1} dy_i
      const float* sb = p.states
                        + (static_cast<size_t>(bh) * p.C + c) * p.N * p.P
                        + static_cast<size_t>(n0) * p.P;
      mac_nt(acc, t.a, t.b, dyb, p.sdy[1], p.sdy[3], rows_q, sb, p.P, 1, wn,
             p.P);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(static_cast<float>(
            t.cum[min(r0 + 4 * ty + i, crow - 1)]));
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
    }
    for (int kt = 0; kt <= qt; ++kt) {      // Σ_{j<=i} w_ij g_j k_j
      const int j0 = kt * kT, rows_k = min(kT, crow - j0);
      float* w = t.w + (kMulti ? kt : 0) * kT * kLd;
      if (!kMulti) scores(kt, w);
      const float* kb = p.k + b * p.sk[0] + h * p.sk[2]
                        + (c0 + j0) * p.sk[1] + n0 * p.sk[3];
      mac_wn(acc, w, t.b, kb, p.sk[1], p.sk[3], rows_k, wn);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ri = 4 * ty + i;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * tx + j;
        if (ri < rows_q && col < wn) {
          p.dq[((static_cast<size_t>(b) * p.L + c0 + r0 + ri) * p.H + h)
                   * p.N + n0 + col] = acc[i][j];
          part = __fmaf_rn(qb[ri * p.sq[1] + (n0 + col) * p.sq[3]],
                           acc[i][j], part);
        }
      }
      part = row_sum16(part);
      if (tx == 0 && ri < rows_q)
        p.qdq[(static_cast<size_t>(nt) * p.B * p.H + bh) * p.L + c0 + r0
              + ri] = part;
    }
  }
}

// ---------------------------------------------------------------------------
// Phase 3b: dk (every 64-column tile of N) or dv (of P) for 64 key rows.
// The block computes the score tile of each query tile first, into shared
// memory, and only then walks the column tiles: no accumulator is live
// while scores are formed (with both, ptxas spilled).  dk and dv are two
// bodies of one kernel, so that neither holds the other's live values.
// ---------------------------------------------------------------------------
template <bool kIsK>
__device__ __forceinline__ void dkdv_tile(const Params& p) {
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kt = blockIdx.z / 2;
  const int width = kIsK ? p.N : p.P;
  const int n_c = cdiv(width, kT);
  const int c0 = c * p.chunk, crow = min(p.chunk, p.L - c0);
  const int j0 = kt * kT;
  if (j0 >= crow) return;
  const Tile t = load_chunk(p, bh, c, crow);
  const int rows_k = min(kT, crow - j0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* kb = p.k + b * p.sk[0] + h * p.sk[2] + (c0 + j0) * p.sk[1];
  const float* vb = p.v + b * p.sv[0] + h * p.sv[2] + (c0 + j0) * p.sv[1];
  const float* qb = p.q + b * p.sq[0] + h * p.sq[2] + c0 * p.sq[1];
  const float* dyb = p.dy + b * p.sdy[0] + h * p.sdy[2] + c0 * p.sdy[1];
  const float* gsb = p.gs + (static_cast<size_t>(bh) * p.C + c) * p.N * p.P;
  const bool carry = c < p.C - 1 || p.d_final != nullptr;
  // The decayed scores of query tile r0 against this key tile, (dy_i·v_j)
  // for dk or (q_i·k_j) for dv, times exp(cum_i - cum_j), into the score
  // tile w, its depth (i) first.
  auto scores = [&](int r0, float* w) {
    const int rows_q = min(kT, crow - r0);
    float s[4][4] = {};
    if constexpr (kIsK)
      mac_nt(s, t.a, t.b, vb, p.sv[1], p.sv[3], rows_k, dyb + r0 * p.sdy[1],
             p.sdy[1], p.sdy[3], rows_q, p.P);
    else
      mac_nt(s, t.a, t.b, kb, p.sk[1], p.sk[3], rows_k, qb + r0 * p.sq[1],
             p.sq[1], p.sq[3], rows_q, p.N);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rj = j0 + 4 * ty + i, ri = r0 + 4 * tx + j;
        w[(4 * tx + j) * kLd + 4 * ty + i] =
            ri >= rj && ri < crow
                ? s[i][j] * expf(static_cast<float>(t.cum[ri] - t.cum[rj]))
                : 0.0f;
      }
  };
  for (int r0 = j0, slot = 0; r0 < crow; r0 += kT, ++slot)
    scores(r0, t.w + slot * kT * kLd);
  for (int ct = 0; ct < n_c; ++ct) {
    const int col0 = ct * kT, wc = min(kT, width - col0);
    float acc[4][4] = {};
    if (carry) {                            // exp(total - cum_j) G_c ...
      if constexpr (kIsK) {                 // ... v_j
        mac_nt(acc, t.a, t.b, vb, p.sv[1], p.sv[3], rows_k,
               gsb + static_cast<size_t>(col0) * p.P, p.P, 1, wc, p.P);
      } else {                              // ... ᵀ k_j
        pipeline(
            cdiv(p.N, kKS),
            [&](int s, int buf) {
              const int d0 = s * kKS;
              stage_t(t.a + buf * kSlab, kb, p.sk[1], p.sk[3], rows_k, p.N,
                      d0);
              stage_n(t.b + buf * kSlab,
                      gsb + static_cast<size_t>(d0) * p.P + col0, p.P, 1,
                      min(kKS, p.N - d0), wc);
            },
            [&](int, int buf) {
              mac(acc, t.a + buf * kSlab, t.b + buf * kSlab);
            });
      }
      const double total = t.cum[crow - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(static_cast<float>(
            total - t.cum[min(j0 + 4 * ty + i, crow - 1)]));
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
    }
    for (int r0 = j0, slot = 0; r0 < crow; r0 += kT, ++slot) {  // i >= j
      const int rows_q = min(kT, crow - r0);
      const float* w = t.w + slot * kT * kLd;
      if constexpr (kIsK)                   // Σ_i w_ij q_i
        mac_wn(acc, w, t.b, qb + r0 * p.sq[1] + col0 * p.sq[3], p.sq[1],
               p.sq[3], rows_q, wc);
      else                                  // Σ_i w_ij dy_i
        mac_wn(acc, w, t.b, dyb + r0 * p.sdy[1] + col0 * p.sdy[3],
               p.sdy[1], p.sdy[3], rows_q, wc);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rj = 4 * ty + i;
      const float gj = rj < rows_k ? t.gate[j0 + rj] : 0.0f;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * tx + j;
        if (rj < rows_k && col < wc) {
          const size_t row = (static_cast<size_t>(b) * p.L + c0 + j0 + rj)
                             * p.H + h;
          if constexpr (kIsK) {
            p.dk[row * p.N + col0 + col] = gj * acc[i][j];
            part = __fmaf_rn(kb[rj * p.sk[1] + (col0 + col) * p.sk[3]],
                             acc[i][j], part);
          } else {
            p.dv[row * p.P + col0 + col] = gj * acc[i][j];
          }
        }
      }
      if constexpr (kIsK) {
        part = row_sum16(part);
        if (tx == 0 && rj < rows_k)
          p.kdk[(static_cast<size_t>(ct) * p.B * p.H + bh) * p.L + c0 + j0
                + rj] = part;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) ssm_bwd_dkdv_kernel(Params p) {
  if (blockIdx.z % 2 == 0)
    dkdv_tile<true>(p);
  else
    dkdv_tile<false>(p);
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

// phases: bit 0 cumsum, 1 chunk d-state, 2 reverse pass, 3 dq, 4 dk/dv, 5
// d log_decay (63 for the function; one bit alone times that kernel on the
// scratch as it is).
int launch(const Params& p, int phases, cudaStream_t stream) {
  const int n_n = cdiv(p.N, kT), n_p = cdiv(p.P, kT);
  const int n_q = cdiv(p.chunk, kT);
  // dk/dv keeps a score tile for each of the chunk's 64-row tiles, dq too
  // where N spans more than one column tile (see the kernels).
  const size_t sm = tile_smem(p.chunk_pad, 0);
  const bool multi_q = n_n > 1;
  void (*dq)(Params) = multi_q ? ssm_bwd_dq_kernel<true>
                               : ssm_bwd_dq_kernel<false>;
  const int slots = p.chunk_pad / kT;
  const size_t sm_dq = tile_smem(p.chunk_pad, multi_q ? slots : 1);
  const size_t sm_dkdv = tile_smem(p.chunk_pad, slots);
  const size_t sm0 = 8 * static_cast<size_t>(p.chunk_pad);
  if (sm_dkdv > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  int e = set_smem(ssm_bwd_cum_kernel, sm0);
  if (!e) e = set_smem(ssm_bwd_dstate_kernel, sm);
  if (!e) e = set_smem(dq, sm_dq);
  if (!e) e = set_smem(ssm_bwd_dkdv_kernel, sm_dkdv);
  if (e) return e;
  const unsigned bh = static_cast<unsigned>(p.B * p.H);
  const int np = p.N * p.P;
  if (phases & 1)
    ssm_bwd_cum_kernel<<<dim3(bh, p.C), kThreads, sm0, stream>>>(p);
  if (phases & 2)
    ssm_bwd_dstate_kernel<<<dim3(bh, p.C, n_n * n_p), kThreads, sm,
                            stream>>>(p);
  if (phases & 4)
    ssm_bwd_state_pass_kernel<<<dim3(bh, cdiv(np, kThreads)), kThreads, 0,
                                stream>>>(p);
  if (phases & 8)
    dq<<<dim3(bh, p.C, n_q), kThreads, sm_dq, stream>>>(p);
  if (phases & 16)
    ssm_bwd_dkdv_kernel<<<dim3(bh, p.C, n_q * 2), kThreads, sm_dkdv,
                          stream>>>(p);
  if (phases & 32)
    ssm_bwd_dlog_kernel<<<bh, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the backward's kernels on `stream`; returns the first CUDA error
// (0 on success), or cudaErrorInvalidValue for a shape the kernels do not
// take (an empty input, chunk outside [1, L], more than 65535 chunks, or
// more shared memory than a block may have).  All float32.  `strides`
// (host memory, in elements): k's four, q's four, v's four, dy's four,
// log_decay's three and gate's three.  d_final [B, H, N, P] contiguous or
// null; states [B, H, C, N, P] (S_{c-1}, the forward's scratch) and s_final
// [B, H, N, P] contiguous; dk, dq [B, L, H, N], dv [B, L, H, P], dld, dg
// [B, L, H] and d_init [B, H, N, P] contiguous outputs; gs [B, H, C, N, P],
// cum [B, H, C, chunk_pad] (float64), etot [B, H, C] and qdq, kdk [N tiles,
// B, H, L] scratch, C = ceil(L / chunk), chunk_pad = chunk rounded up to a
// multiple of 64, N tiles = ceil(N / 64).  has_s0: the forward had an
// initial state (else S_{-1} = 0 and chunk 0 skips its carry).
extern "C" int ssm_scan_bwd_launch(
    const void* k, const void* q, const void* v, const void* ld,
    const void* g, const void* dy, const void* d_final, const void* states,
    const void* s_final, void* dk, void* dq, void* dv, void* dld, void* dg,
    void* d_init, void* gs, void* cum, void* etot, void* qdq, void* kdk,
    const long long* strides, int has_s0, int B, int L, int H, int N, int P,
    int chunk, int phases, void* stream) {
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
  if (p.C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, phases, static_cast<cudaStream_t>(stream));
}

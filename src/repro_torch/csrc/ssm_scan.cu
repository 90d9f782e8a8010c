// Chunked SSD scan for Hopper (sm_90a): the gated linear recurrence of
// Mamba2 (and mLSTM), S_t = exp(ld_t)·S_{t-1} + g_t·k_t v_tᵀ, y_t = q_t·S_t,
// evaluated chunk by chunk in float32.
//
// Replaces the TPU kernel `ssm_scan_call` / `_kernel` of
// src/repro/kernels/ssm_scan/kernel.py (`_kernel` at line 27, the wrapper
// at line 68, pallas_call at line 83).  k, q [B, L, H, N] and v [B, L, H, P]
// (float32 or bfloat16, any strides: Mamba2's B and C come with a head
// stride of 0), log_decay and gate [B, L, H] float32 (any strides) and an
// optional initial state [B, H, N, P] float32 give y [B, L, H, P] and the
// final state [B, H, N, P], both float32.  Per chunk of `chunk` rows:
//   intra:  y_i  = sum_{j<=i} (q_i·k_j) exp(cum_i - cum_j) g_j v_j
//   carry:  y_i += exp(cum_i) · (q_i S_prev)
//   update: S    = exp(total)·S_prev + sum_j exp(total - cum_j) g_j k_j v_jᵀ
// where cum is the within-chunk inclusive sum of log_decay and total its
// last value.  Any L: the last chunk simply ends at L, which is what the
// reference's tail padding computes (gate 0 and log-decay 0 leave y and
// the state of the real rows as they are).  The plain PyTorch version is
// src/repro_torch/kernels/ssm_scan/ref.py.
//
// Order and precision of sums, which differ from the plain version's: the
// within-chunk cumsum is accumulated in float64.  It splits the chunk into
// 32 contiguous runs; each lane of one warp sums its run left to right, a
// shuffle scan (Hillis-Steele) gives the runs' inclusive totals, and each
// run adds the total of the runs before it.  Each decay exponent (cum_i -
// cum_j, total - cum_j, cum_i, total) is taken in float64 and rounded once
// to float32 before expf.  The plain version, as the reference, sums and
// subtracts in float32, which loses the digits of cum_i - cum_j where
// |cum| is much larger (a long chunk or a fast decay: deep in a random
// 81-layer model the per-step log-decay reaches tens); the kernel's
// weights are the more accurate, and chip_smoke.py judges the two against
// a float64 evaluation where they disagree.  Products over N and over keys
// are fmaf chains (the build keeps -fmad=false), in an order other than
// the CPU's BLAS.  Built with -ftz=true: where exp(cum) falls below
// float32's normal range on a long chunk the card gives 0 where the CPU
// gives a subnormal, an absolute difference under 1.2e-38.
//
// Bound on the H100: operations.  At zamba2-7b's prefill (B = 4, L =
// 1000, H = 112, N = P = 64, chunk 256) the function's least work is the
// step-by-step recurrence, 5·N·P + N operations a row, 9.2 GFLOP: 0.137 ms
// at the published 67 TFLOP/s of float32 outside the tensor cores,
// against about 0.24 GB of v, y and the state (k and q once each through
// their head stride of 0), 0.072 ms at 3.35 TB/s.  The chunked form this
// kernel runs needs 22 GFLOP (the causal pairs of the intra product, the
// carry and the update), 0.33 ms on the CUDA cores.
//
// Design: one block of 256 threads per (batch, head) loops over the chunks
// itself, as the TPU grid's sequential chunk axis did, and keeps S [N, P]
// in shared memory from one chunk to the next.  The chunk's scores are
// tiled in 64-row query tiles against 64-row key tiles up to the diagonal
// (a 256 x 256 float32 score matrix would not fit in a block's shared
// memory).  Each thread holds a 4 x 4 block of scores (rows ty + 16i, keys
// tx + 16j) and a 4 x 4 block of outputs (rows ty + 16i, columns 4tx + e),
// reads its operands from shared memory as float4 and accumulates with
// fmaf.  The diagonal tile also feeds the state update, kept in registers
// (rows n = ty + 16i, columns 4tx + e) until the chunk ends.  N and P are
// zero-padded to 64 in shared memory.  All float32 on the CUDA cores, for
// both input types (no tensor cores yet): on the CUDA cores the chunked
// form cannot go under its own 0.33 ms, 2.4x the bound; the chunked form
// on the tensor cores, or the recurrence itself, could come near it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // rows of a query or key tile
constexpr int kW = 64;               // N and P, zero-padded
constexpr int kStride = kW + 4;      // row stride of every shared tile

struct Params {
  const void* k;
  const void* q;
  const void* v;
  const float* ld;
  const float* g;
  const float* s0;                   // null: the state starts at 0
  float* y;
  float* s_out;
  long long sk[4], sq[4], sv[4], sld[3], sg[3];
  int B, L, H, N, P, chunk;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// `rows` rows of `width` values (row stride s_row, column stride s_col)
// into dst [kTile][kStride] as float32, zero elsewhere.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      long long s_row, long long s_col,
                                      int rows, int width) {
  for (int i = threadIdx.x; i < kTile * kW; i += kThreads) {
    const int r = i / kW, c = i % kW;
    float val = 0.0f;
    if (r < rows && c < width) val = to_f(src[r * s_row + c * s_col]);
    dst[r * kStride + c] = val;
  }
}

__device__ __forceinline__ float comp(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssm_scan_kernel(Params p) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [kTile][kStride] q rows
  float* ks = qs + kTile * kStride;        // [kTile][kStride] k rows
  float* vs = ks + kTile * kStride;        // [kTile][kStride] v rows
  float* ps = vs + kTile * kStride;        // [kTile][kStride] weighted scores
  float* ss = ps + kTile * kStride;        // [kW][kStride] the state S
  // [chunk] within-chunk cumsum, float64 (8-byte aligned: 5 tiles above)
  double* cum = reinterpret_cast<double*>(ss + kW * kStride);
  float* gs = reinterpret_cast<float*>(cum + p.chunk);  // [chunk] gate
  float* ecum = gs + p.chunk;              // [chunk] exp(cum)
  float* win = ecum + p.chunk;             // [chunk] exp(total - cum)·g

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* qb = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* vb = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const float* ldb = p.ld + b * p.sld[0] + h * p.sld[2];
  const float* gb = p.g + b * p.sg[0] + h * p.sg[2];

  for (int i = threadIdx.x; i < kW * kW; i += kThreads) {
    const int n = i / kW, c = i % kW;
    float val = 0.0f;
    if (p.s0 != nullptr && n < p.N && c < p.P)
      val = p.s0[(static_cast<size_t>(bh) * p.N + n) * p.P + c];
    ss[n * kStride + c] = val;
  }

  for (int c0 = 0; c0 < p.L; c0 += p.chunk) {
    const int crow = min(p.chunk, p.L - c0);
    __syncthreads();                       // the previous chunk is done
    for (int r = threadIdx.x; r < crow; r += kThreads) {
      cum[r] = static_cast<double>(
          ldb[static_cast<long long>(c0 + r) * p.sld[1]]);
      gs[r] = gb[static_cast<long long>(c0 + r) * p.sg[1]];
    }
    __syncthreads();
    if (threadIdx.x < 32) {                // the cumsum: 32 runs, then scan
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
    const double total = cum[crow - 1];
    for (int r = threadIdx.x; r < crow; r += kThreads) {
      ecum[r] = expf(static_cast<float>(cum[r]));
      win[r] = expf(static_cast<float>(total - cum[r])) * gs[r];
    }

    float ds[4][4];                        // this chunk's state increment
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[i][e] = 0.0f;

    const int n_tiles = (crow + kTile - 1) / kTile;
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int r0 = qt * kTile;
      const int rows_q = min(kTile, crow - r0);
      __syncthreads();                     // qs and the chunk arrays ready
      stage(qs, qb + (c0 + r0) * p.sq[1], p.sq[1], p.sq[3], rows_q, p.N);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        const int rows_k = min(kTile, crow - k0);
        __syncthreads();                   // ks, vs and ps are free
        stage(ks, kb + (c0 + k0) * p.sk[1], p.sk[1], p.sk[3], rows_k, p.N);
        stage(vs, vb + (c0 + k0) * p.sv[1], p.sv[1], p.sv[3], rows_k, p.P);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < kW; d += 4) {
          float4 qv[4], kv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qv[i] = *reinterpret_cast<const float4*>(
                qs + (ty + 16 * i) * kStride + d);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kv[j] = *reinterpret_cast<const float4*>(
                ks + (tx + 16 * j) * kStride + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float a = s[i][j];
              a = fmaf(qv[i].x, kv[j].x, a);
              a = fmaf(qv[i].y, kv[j].y, a);
              a = fmaf(qv[i].z, kv[j].z, a);
              a = fmaf(qv[i].w, kv[j].w, a);
              s[i][j] = a;
            }
        }
        // (q_i·k_j)·exp(cum_i - cum_j)·g_j for j <= i, else 0.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = ty + 16 * i;
          const int row = r0 + qi;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kj = tx + 16 * j;
            const int key = k0 + kj;
            float w = 0.0f;
            if (qi < rows_q && kj < rows_k && key <= row)
              w = s[i][j] * expf(static_cast<float>(cum[row] - cum[key]))
                  * gs[key];
            ps[qi * kStride + kj] = w;
          }
        }
        __syncthreads();

        // y += weighted scores · V
        for (int t = 0; t < rows_k; t += 4) {
          float4 pv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pv[i] = *reinterpret_cast<const float4*>(
                ps + (ty + 16 * i) * kStride + t);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 vv = *reinterpret_cast<const float4*>(
                vs + (t + u) * kStride + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pr = comp(pv[i], u);
              acc[i][0] = fmaf(pr, vv.x, acc[i][0]);
              acc[i][1] = fmaf(pr, vv.y, acc[i][1]);
              acc[i][2] = fmaf(pr, vv.z, acc[i][2]);
              acc[i][3] = fmaf(pr, vv.w, acc[i][3]);
            }
          }
        }
        if (kt == qt) {                    // each key tile once: the update
          for (int t = 0; t < rows_k; ++t) {
            const float w = win[k0 + t];
            const float4 vv = *reinterpret_cast<const float4*>(
                vs + t * kStride + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float kw = ks[t * kStride + ty + 16 * i] * w;
              ds[i][0] = fmaf(kw, vv.x, ds[i][0]);
              ds[i][1] = fmaf(kw, vv.y, ds[i][1]);
              ds[i][2] = fmaf(kw, vv.z, ds[i][2]);
              ds[i][3] = fmaf(kw, vv.w, ds[i][3]);
            }
          }
        }
      }

      // The carry, exp(cum_i)·(q_i S_prev), then y = intra + carry.
      float inter[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) inter[i][e] = 0.0f;
      for (int n = 0; n < p.N; ++n) {
        const float4 sv4 = *reinterpret_cast<const float4*>(
            ss + n * kStride + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float qn = qs[(ty + 16 * i) * kStride + n];
          inter[i][0] = fmaf(qn, sv4.x, inter[i][0]);
          inter[i][1] = fmaf(qn, sv4.y, inter[i][1]);
          inter[i][2] = fmaf(qn, sv4.z, inter[i][2]);
          inter[i][3] = fmaf(qn, sv4.w, inter[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = ty + 16 * i;
        if (qi >= rows_q) continue;
        const float ec = ecum[r0 + qi];
        float* yr = p.y + ((static_cast<size_t>(b) * p.L + c0 + r0 + qi)
                           * p.H + h) * p.P;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 4 * tx + e;
          if (col < p.P) yr[col] = acc[i][e] + inter[i][e] * ec;
        }
      }
    }

    __syncthreads();                       // every carry has read S_prev
    const float etot = expf(static_cast<float>(total));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* sr = ss + (ty + 16 * i) * kStride + 4 * tx;
#pragma unroll
      for (int e = 0; e < 4; ++e) sr[e] = sr[e] * etot + ds[i][e];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < p.N * p.P; i += kThreads) {
    const int n = i / p.P, c = i % p.P;
    p.s_out[static_cast<size_t>(bh) * p.N * p.P + i] = ss[n * kStride + c];
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  // Five float tiles, the float64 cumsum and three float arrays a chunk.
  const size_t smem = sizeof(float) * (5 * static_cast<size_t>(kTile)
                                       * kStride
                                       + 5 * static_cast<size_t>(p.chunk));
  cudaError_t e = cudaFuncSetAttribute(
      ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssm_scan_kernel<T><<<p.B * p.H, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take
// (N or P outside [1, 64], an empty input, chunk < 1).  bf16 != 0: k, q and
// v are bfloat16, else float32.  `strides` (host memory, in elements): k's
// four, q's four, v's four, log_decay's three and gate's three.  s0 is a
// contiguous float32 [B, H, N, P] or null; y [B, L, H, P] and s_out
// [B, H, N, P] are contiguous float32.  The caller passes chunk <= L.
extern "C" int ssm_scan_launch(const void* k, const void* q, const void* v,
                               const void* ld, const void* g, const void* s0,
                               void* y, void* s_out, const long long* strides,
                               int bf16, int B, int L, int H, int N, int P,
                               int chunk, void* stream) {
  if (B < 1 || L < 1 || H < 1 || N < 1 || N > kW || P < 1 || P > kW
      || chunk < 1 || chunk > L)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, st) : launch<float>(p, st);
}

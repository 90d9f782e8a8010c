// Flash-attention backward for Hopper (sm_90a): the gradients dq, dk, dv
// of csrc/flash_attention.cu's float32 forward, on the CUDA cores.
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
// Per (query, key) pair the kernels recompute the raw score s = q.k with
// the forward's own order of products (one fmaf chain over d ascending),
// so s, the softcap's tanh and the mask are the forward's bit for bit,
// and P = exp(x - lse) from the forward's log-sum-exp lse [B, H, S].
// With dP = dO.v and delta = rowsum(dO * O):
//   dS = P (dP - delta), zero where the mask removes the pair, times
//   (1 - tanh^2) under the softcap;
//   dV = sum over query rows of P dO, dK = scale * sum of dS q, and
//   dQ = scale * sum over keys of dS k.
// A row with no live key at all (a window that closes before key 0 can
// open: rows at or past T + window - 1) is the softmax of a constant
// row: P = 1/T on every key, dS = 0.
//
// Three kernels a call, no atomics, so two runs give the same bits:
// 1. bwd_delta_kernel: delta, one warp a row (a fixed shuffle tree);
// 2. bwd_dkdv_kernel: one block of 256 threads per (batch, KV head,
//    32-key tile).  K and V stay in shared memory; the block walks every
//    query head of the KV head's group and every query tile that has a
//    live pair with its keys (or a dead row), in order, and writes dK and
//    dV once.  The eight heads of gemma-2b's MQA group add into one dK in
//    that fixed order.
// 3. bwd_dq_kernel: one block per (batch, query head, 32-row query tile),
//    heaviest causal tiles first, walking the live key tiles.
// Tiles are 32 x 32: at D = 256 in float32, 64-key tiles of K and V plus
// their dK/dV accumulators would take 256 KB, past the 227 KB a block may
// have.  With 32-key tiles K and V take 65 KB of shared memory, the Q and
// dO tiles another 65 KB, P and dS 8 KB (139 KB in all at D = 256), and
// the accumulators live in registers: each thread owns 2 keys (or 2 query
// rows) x D/16 columns of dK and dV (64 floats a thread at D = 256), the
// forward's layout.  Each thread computes a 2 x 2 block of S and of dP
// from float4 reads (rows padded by 4 floats: no bank conflicts).
//
// Bound on the H100: operations.  Five products of 2.D.H FLOP per live
// pair (S and dP recomputed, dV, dK, dQ): gemma-2b's layer (H 8, D 256,
// S = T = 2048, causal) needs 43 GFLOP, 0.64 ms at float32's 67 TFLOP/s.
// Known gap: under MQA (KH 1) kernel 2 has only T/32 blocks (64 at T
// 2048, on 132 SMs), and the causal first key tile walks all 8 heads x
// 64 query tiles: it sets the kernel's time.  Splitting the group over
// blocks and summing the partial dK/dV in a fixed order, `wgmma` and TMA
// are later work.
//
// Built with -fmad=false (products are contracted only where written as
// fmaf) and IEEE expf, tanhf, as the forward.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 32;             // query rows of a tile
constexpr int kBK = 32;             // keys of a tile
constexpr int kSStride = kBK + 1;   // P and dS tiles: [kBQ][kBK + 1]

struct Params {
  int H, KH, S, T, D;
  float scale, softcap;
  int causal, window;   // window <= 0: none
  int use_softcap;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc + a.b over the four lanes, x first: the forward's order.
__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4_into(float* acc, float s, float4 b) {
  acc[0] = fmaf(s, b.x, acc[0]);
  acc[1] = fmaf(s, b.y, acc[1]);
  acc[2] = fmaf(s, b.z, acc[2]);
  acc[3] = fmaf(s, b.w, acc[3]);
}

// ROWS x D of `src` (row stride D) into `dst` ([ROWS][DP + 4]), zero
// outside [0, rows) x [0, D).  D is a multiple of 4.
template <int ROWS, int DP>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int rows, int D) {
  constexpr int kVec = DP / 4;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec, d = (i % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && d < D) val = load4(src + static_cast<size_t>(r) * D + d);
    *reinterpret_cast<float4*>(dst + r * (DP + 4) + d) = val;
  }
}

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

// The block's 2 x 2 pairs (rows ty + 16i, keys tx + 16j) of one query tile
// (qs, dos, row lse and delta) against one key tile (ks, vs): P and dS
// into ps and dss ([kBQ][kSStride]).  Rows past S and keys past T get 0.
template <int DP>
__device__ __forceinline__ void pair_tile(
    const Params& p, const float* qs, const float* dos, const float* ks,
    const float* vs, const float* lse_s, const float* dl_s, int q0, int k0,
    float* ps, float* dss) {
  constexpr int kStr = DP + 4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[2][2], dp[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 qa[2], da[2], kb[2], vb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      qa[i] = load4(qs + (ty + 16 * i) * kStr + d);
      da[i] = load4(dos + (ty + 16 * i) * kStr + d);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kb[j] = load4(ks + (tx + 16 * j) * kStr + d);
      vb[j] = load4(vs + (tx + 16 * j) * kStr + d);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[i][j] = fma4(qa[i], kb[j], s[i][j]);
        dp[i][j] = fma4(da[i], vb[j], dp[i][j]);
      }
  }
  const float inv_t = 1.0f / static_cast<float>(p.T);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i, qp = q0 + r;
    int lo, hi;
    live_range(p, qp, &lo, &hi);
    const bool dead = lo > hi;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tx + 16 * j, kp = k0 + c;
      float pr = 0.0f, ds = 0.0f;
      if (qp < p.S && kp < p.T) {
        if (dead) {
          pr = inv_t;
        } else if (kp >= lo && kp <= hi) {
          float x = s[i][j] * p.scale;
          float th = 0.0f;
          if (p.use_softcap) {
            th = tanhf(x / p.softcap);
            x = p.softcap * th;
          }
          pr = expf(x - lse_s[r]);
          ds = pr * (dp[i][j] - dl_s[r]);
          if (p.use_softcap) ds = ds * (1.0f - th * th);
        }
      }
      ps[r * kSStride + c] = pr;
      dss[r * kSStride + c] = ds;
    }
  }
}

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

// At DP >= 192 the tiles' shared memory (106-139 KB) leaves one block an
// SM, so the register budget may take the whole file (the accumulators
// stay in registers, no spill); below, two blocks an SM.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP >= 192 ? 1 : 2)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, Params p) {
  constexpr int kStr = DP + 4;
  constexpr int kCols = DP / 64;           // float4 columns a thread
  extern __shared__ float smem[];
  float* ks = smem;                        // [kBK][kStr]
  float* vs = ks + kBK * kStr;             // [kBK][kStr]
  float* qs = vs + kBK * kStr;             // [kBQ][kStr]
  float* dos = qs + kBQ * kStr;            // [kBQ][kStr]
  float* ps = dos + kBQ * kStr;            // [kBQ][kSStride]
  float* dss = ps + kBQ * kSStride;        // [kBQ][kSStride]
  float* lse_s = dss + kBQ * kSStride;     // [kBQ]
  float* dl_s = lse_s + kBQ;               // [kBQ]

  const int kr = threadIdx.x / 16, c = threadIdx.x % 16;
  const int bkv = blockIdx.y;              // b * KH + KV head
  const int b = bkv / p.KH, g = bkv % p.KH;
  const int group = p.H / p.KH;
  const int k0 = blockIdx.x * kBK;
  const int k_rows = min(kBK, p.T - k0);
  const int k_last = k0 + k_rows - 1;
  stage<kBK, DP>(ks, k + (static_cast<size_t>(bkv) * p.T + k0) * p.D,
                 k_rows, p.D);
  stage<kBK, DP>(vs, v + (static_cast<size_t>(bkv) * p.T + k0) * p.D,
                 k_rows, p.D);

  float dka[2][kCols][4], dva[2][kCols][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[i][j][e] = dva[i][j][e] = 0.0f;

  const int n_q = (p.S + kBQ - 1) / kBQ;
  for (int hh = 0; hh < group; ++hh) {
    const int bh = b * p.H + g * group + hh;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q0 = qt * kBQ;
      const int q_rows = min(kBQ, p.S - q0);
      const int q_last = q0 + q_rows - 1;
      int lo, hi;
      live_range(p, q_last, &lo, &hi);     // dead rows are a suffix
      if (!tiles_meet(p, q0, q_last, k0, k_last) && lo <= hi) continue;
      __syncthreads();                     // the previous tile consumed
      const size_t row0 = static_cast<size_t>(bh) * p.S + q0;
      stage<kBQ, DP>(qs, q + row0 * p.D, q_rows, p.D);
      stage<kBQ, DP>(dos, dout + row0 * p.D, q_rows, p.D);
      if (threadIdx.x < kBQ) {
        const bool in = static_cast<int>(threadIdx.x) < q_rows;
        lse_s[threadIdx.x] = in ? lse[row0 + threadIdx.x] : 0.0f;
        dl_s[threadIdx.x] = in ? delta[row0 + threadIdx.x] : 0.0f;
      }
      __syncthreads();
      pair_tile<DP>(p, qs, dos, ks, vs, lse_s, dl_s, q0, k0, ps, dss);
      __syncthreads();
      for (int r = 0; r < q_rows; ++r) {
        const float p0 = ps[r * kSStride + kr];
        const float p1 = ps[r * kSStride + kr + 16];
        const float s0 = dss[r * kSStride + kr];
        const float s1 = dss[r * kSStride + kr + 16];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float4 dov = load4(dos + r * kStr + 4 * (c + 16 * j));
          const float4 qv = load4(qs + r * kStr + 4 * (c + 16 * j));
          fma4_into(dva[0][j], p0, dov);
          fma4_into(dva[1][j], p1, dov);
          fma4_into(dka[0][j], s0, qv);
          fma4_into(dka[1][j], s1, qv);
        }
      }
    }
  }

  const size_t base = static_cast<size_t>(bkv) * p.T + k0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kr + 16 * i;
    if (key >= k_rows) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (c + 16 * j) + e;
        if (d < p.D) {
          dk[(base + key) * p.D + d] = dka[i][j][e] * p.scale;
          dv[(base + key) * p.D + d] = dva[i][j][e];
        }
      }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP >= 192 ? 1 : 2)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq,
              Params p) {
  constexpr int kStr = DP + 4;
  constexpr int kCols = DP / 64;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][kStr]
  float* dos = qs + kBQ * kStr;            // [kBQ][kStr]
  float* ks = dos + kBQ * kStr;            // [kBK][kStr]
  float* vs = ks + kBK * kStr;             // [kBK][kStr]
  float* ps = vs + kBK * kStr;             // [kBQ][kSStride]
  float* dss = ps + kBQ * kSStride;        // [kBQ][kSStride]
  float* lse_s = dss + kBQ * kSStride;     // [kBQ]
  float* dl_s = lse_s + kBQ;               // [kBQ]

  const int rr = threadIdx.x / 16, c = threadIdx.x % 16;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = b * p.KH + h / (p.H / p.KH);
  const int qi = gridDim.x - 1 - blockIdx.x;   // heaviest causal first
  const int q0 = qi * kBQ;
  const int q_rows = min(kBQ, p.S - q0);
  const int q_last = q0 + q_rows - 1;
  const size_t row0 = static_cast<size_t>(bh) * p.S + q0;
  stage<kBQ, DP>(qs, q + row0 * p.D, q_rows, p.D);
  stage<kBQ, DP>(dos, dout + row0 * p.D, q_rows, p.D);
  if (threadIdx.x < kBQ) {
    const bool in = static_cast<int>(threadIdx.x) < q_rows;
    lse_s[threadIdx.x] = in ? lse[row0 + threadIdx.x] : 0.0f;
    dl_s[threadIdx.x] = in ? delta[row0 + threadIdx.x] : 0.0f;
  }

  float acc[2][kCols][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const float* kb = k + static_cast<size_t>(kvh) * p.T * p.D;
  const float* vb = v + static_cast<size_t>(kvh) * p.T * p.D;
  const int n_kv = (p.T + kBK - 1) / kBK;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, p.T - k0);
    if (p.causal && k0 > q_last) break;
    // Dead rows take no gradient: only tiles with a live pair count.
    if (!tiles_meet(p, q0, q_last, k0, k0 + k_rows - 1)) continue;
    __syncthreads();                       // the previous tile consumed
    stage<kBK, DP>(ks, kb + static_cast<size_t>(k0) * p.D, k_rows, p.D);
    stage<kBK, DP>(vs, vb + static_cast<size_t>(k0) * p.D, k_rows, p.D);
    __syncthreads();
    pair_tile<DP>(p, qs, dos, ks, vs, lse_s, dl_s, q0, k0, ps, dss);
    __syncthreads();
    for (int key = 0; key < k_rows; ++key) {
      const float s0 = dss[rr * kSStride + key];
      const float s1 = dss[(rr + 16) * kSStride + key];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 kv = load4(ks + key * kStr + 4 * (c + 16 * j));
        fma4_into(acc[0][j], s0, kv);
        fma4_into(acc[1][j], s1, kv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rr + 16 * i;
    if (r >= q_rows) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (c + 16 * j) + e;
        if (d < p.D) dq[(row0 + r) * p.D + d] = acc[i][j][e] * p.scale;
      }
  }
}

struct Ptrs {
  const float *q, *k, *v, *o, *lse, *dout;
  float *dq, *dk, *dv, *delta;
};

template <int DP>
int launch(const Ptrs& t, int B, const Params& p, int phases,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((2 * kBK + 2 * kBQ) * (DP + 4)
                                       + 2 * kBQ * kSStride + 2 * kBQ);
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
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((p.T + kBK - 1) / kBK, B * p.KH);
    if (grid.x > 0 && grid.y > 0)
      bwd_dkdv_kernel<DP><<<grid, kThreads, smem, stream>>>(
          t.q, t.k, t.v, t.dout, t.lse, t.delta, t.dk, t.dv, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (phases & 4) {
    cudaError_t e = cudaFuncSetAttribute(
        bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((p.S + kBQ - 1) / kBQ, B * p.H);
    if (grid.x > 0 && grid.y > 0)
      bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
          t.q, t.k, t.v, t.dout, t.lse, t.delta, t.dq, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernels named by `phases` (1: delta, 2: dK/dV, 4: dQ; 7
// for a whole backward) on `stream`, in that order; returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a shape the kernels do not take (D > 256 or
// not a multiple of 4, H not a multiple of KH).  All tensors float32 and
// contiguous: q, o, dout, dq [B, H, S, D]; k, v, dk, dv [B, KH, T, D];
// lse (the forward's) and delta (scratch) [B, H, S].  window <= 0 means
// no window; use_softcap == 0 means no softcap.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int B, int H, int KH, int S, int T, int D, float scale,
    int causal, int window, int use_softcap, float softcap, int phases,
    void* stream) {
  if (D <= 0 || D > 256 || D % 4 != 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{H, KH, S, T, D, scale, softcap, causal, window,
                 use_softcap};
  const Ptrs t{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(o),
               static_cast<const float*>(lse),
               static_cast<const float*>(dout), static_cast<float*>(dq),
               static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(delta)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64>(t, B, p, phases, st);
  if (D <= 128) return launch<128>(t, B, p, phases, st);
  if (D <= 192) return launch<192>(t, B, p, phases, st);
  return launch<256>(t, B, p, phases, st);
}

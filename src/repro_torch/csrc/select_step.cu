// Fused Lynceus selector step for Hopper (sm_90a): one thread block per
// speculative state.
//
// Replaces the TPU kernel `select_step_call` / `_kernel` of
// src/repro/kernels/select_step/kernel.py (pallas_call at line 255).  For
// every speculative state s it descends the state's bagged forest for all M
// candidate points, forms mu/sigma with forest_mu_sigma's pinned chains,
// applies censored_adjust, the incumbent y* (incumbent_fallback),
// constrained EI through the fenced _exp_det/_Phi polynomials, the
// candidate mask (untested, valid, budget_ok), the policy score, the
// 12-bit quantize_scores rounding and the masked argmax (lowest index on
// exact ties).  The plain PyTorch version is
// src/repro_torch/kernels/select_step/ref.py; the two agree bit for bit.
//
// Bound on the H100: memory.  A depth-2 lookahead launch (S = 3456 states,
// B = 10 trees of depth 4, M = 384 points) reads about 19 MB (feat/thr
// [S,B,D,W], leaf [S,B,L], y/obs/cens [S,M]) and does about 53 M node
// visits plus some 200 M flops, ~6 us of HBM time against ~3 us of fp32.
// The design reads each state's inputs once: the state's forest and the
// points go to shared memory, each thread descends the trees for its
// points, and only the pick (or, for the root sweep, the requested full
// rows) is written back.  The TPU kernel's one-hot feature matmul existed
// only because the TPU cannot gather; here the descent gathers from the
// points tile in shared memory.
//
// Arithmetic contract (what makes the kernel equal its plain version):
// built with -fmad=false (no product contracted into an FMA but the
// explicit __fmaf_rn of minus_mu, which reproduces the one contraction the
// reference's compiled program makes), IEEE
// division and square root (-prec-div=true -prec-sqrt=true, never
// --use_fast_math) and -ftz=true (float32 subnormals flush to zero, as the
// reference's XLA CPU backend computes and the plain version emulates).
// Every float operation below is the same operation, in the same order, as
// the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// The reference's float32 constants, exactly (np.float32 of its literals).
constexpr float kLog2e = 0x1.715476p+0f;
constexpr float kLn2Hi = 0x1.63p-1f;
constexpr float kLn2Lo = -0x1.bd0106p-13f;
constexpr float kExp0 = 0x1.6c16c2p-10f;     // 1/720
constexpr float kExp1 = 0x1.111112p-7f;      // 1/120
constexpr float kExp2 = 0x1.555556p-5f;      // 1/24
constexpr float kExp3 = 0x1.555556p-3f;      // 1/6
constexpr float kInvSqrt2Pi = 0x1.988454p-2f;
constexpr float kPhiP = 0x1.da6712p-3f;
constexpr float kPhiB0 = 0x1.548cdep+0f;
constexpr float kPhiB1 = -0x1.d23dd4p+0f;
constexpr float kPhiB2 = 0x1.c80ef0p+0f;
constexpr float kPhiB3 = -0x1.6d1f0ep-2f;
constexpr float kPhiB4 = 0x1.470bf4p-2f;
constexpr float kSqrt2 = 0x1.6a09e6p+0f;
constexpr float kSigEps = 0x1.197998p-40f;   // 1e-12
constexpr float kRatioEps = 0x1.12e0bep-30f; // 1e-9

__device__ __forceinline__ float nc(float x) {     // acquisition.no_contract
  return x == x ? x : 0.0f;
}

// torch.maximum / jnp.maximum (and their max reductions): NaN-propagating;
// ties return b.
__device__ __forceinline__ float maxf(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float quantize(float x, int bits) {
  const uint32_t half = 1u << (22 - bits);
  const uint32_t mask = 0xFFFFFFFFu << (23 - bits);
  const uint32_t q = (__float_as_uint(x) + half) & mask;
  return x != x ? x : __uint_as_float(q);
}

__device__ __forceinline__ float exp_det(float x) {
  const float n = rintf(x * kLog2e);
  const float r = (x - nc(n * kLn2Hi)) - nc(n * kLn2Lo);
  float acc = kExp0;
  acc = nc(acc * r) + kExp1;
  acc = nc(acc * r) + kExp2;
  acc = nc(acc * r) + kExp3;
  acc = nc(acc * r) + 0.5f;
  acc = nc(acc * r) + 1.0f;
  acc = nc(acc * r) + 1.0f;
  // float -> int32 saturates and maps NaN to 0, as XLA's convert does.
  const uint32_t bits = __float_as_uint(acc)
                        + (static_cast<uint32_t>(static_cast<int>(n)) << 23);
  const float out = __uint_as_float(bits);
  return x < -86.0f ? 0.0f : out;
}

__device__ __forceinline__ float phi(float z) {
  return kInvSqrt2Pi * exp_det((-0.5f * z) * z);
}

__device__ __forceinline__ float Phi(float z) {
  const float a = fabsf(z);
  const float t = 1.0f / (nc(kPhiP * a) + 1.0f);
  float poly = kPhiB0;
  poly = nc(poly * t) + kPhiB1;
  poly = nc(poly * t) + kPhiB2;
  poly = nc(poly * t) + kPhiB3;
  poly = nc(poly * t) + kPhiB4;
  const float tail = nc(phi(a) * (poly * t));
  return z >= 0.0f ? 1.0f - tail : tail;
}

// c - mu.  Where mu is the raw forest mean acc * inv_b (no censoring),
// the reference's backend contracts that product into the subtraction:
// one rounding, as fmaf gives it (an explicit fma is kept under
// -fmad=false).
__device__ __forceinline__ float minus_mu(float c, float mu, float acc,
                                         float inv_b, bool contract) {
  return contract ? __fmaf_rn(-acc, inv_b, c) : c - mu;
}

__device__ __forceinline__ float ei_constrained(float mu, float acc,
                                                float inv_b, bool contract,
                                                float sigma, float ystar,
                                                float u, float t_max) {
  const float s = maxf(sigma, kSigEps);
  const float d = minus_mu(ystar, mu, acc, inv_b, contract);
  const float z = d / s;
  const float ei = maxf(nc(d * Phi(z)) + nc(s * phi(z)), 0.0f);
  const float bound = nc(t_max * u);
  const float p = Phi(minus_mu(bound, mu, acc, inv_b, contract) / s);
  return ei * p;
}

// Argmax combine: NaN beats numbers, larger beats smaller, the lower index
// wins exact ties (torch.argmax / jnp.argmax semantics).
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

struct Params {
  const int* feat; const float* thr; const float* leaf;
  const float* y; const uint8_t* obs; const uint8_t* cens;
  const float* beta; const float* bf;
  const float* points; const float* u; const uint8_t* valid;
  const float* xi; const float* scal;
  float conf_q, cens_rel;
  int S, B, D, W, L, M, F, K;
  int score_ratio, use_budget, emit_full, want_nodes;
  float* mu; float* sigma; float* eic; float* ystar; uint8_t* cand;
  int* sel; uint8_t* has; float* nodes;
  float* eic_sel; float* mu_sel; float* sig_sel;
};

__device__ __forceinline__ float predict(const int* feat, const float* thr,
                                         const float* leaf, const float* x,
                                         int b, int D, int W, int L) {
  int pos = 0;
  for (int lvl = 0; lvl < D; ++lvl) {
    const int f = feat[(b * D + lvl) * W + pos];
    const float t = thr[(b * D + lvl) * W + pos];
    pos = 2 * pos + (x[f] > t ? 1 : 0);
  }
  return leaf[b * L + pos];
}

__global__ void __launch_bounds__(kThreads)
select_step_kernel(Params p) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int nodes_per_tree = p.D * p.W;
  int* s_feat = reinterpret_cast<int*>(smem);
  float* s_thr = smem + p.B * nodes_per_tree;
  float* s_leaf = s_thr + p.B * nodes_per_tree;
  float* s_pts = s_leaf + p.B * p.L;
  float* s_mu = s_pts + p.M * p.F;
  float* s_sig = s_mu + p.M;
  float* s_eic = s_sig + p.M;
  float* s_acc = s_eic + p.M;
  __shared__ float red_a[kWarps], red_b[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float s_ystar;

  const size_t fo = static_cast<size_t>(s) * p.B * nodes_per_tree;
  for (int i = tid; i < p.B * nodes_per_tree; i += kThreads) {
    s_feat[i] = p.feat[fo + i];
    s_thr[i] = p.thr[fo + i];
  }
  const size_t lo = static_cast<size_t>(s) * p.B * p.L;
  for (int i = tid; i < p.B * p.L; i += kThreads) s_leaf[i] = p.leaf[lo + i];
  for (int i = tid; i < p.M * p.F; i += kThreads) s_pts[i] = p.points[i];
  __syncthreads();

  const size_t ro = static_cast<size_t>(s) * p.M;
  const float t_max = p.scal[0];
  const float floor_ = p.scal[1];
  // The reference's acc / B compiles to acc * f32(1/B) (XLA rewrites a
  // division by a constant into a product with its reciprocal).
  const float inv_b = 1.0f / static_cast<float>(p.B);
  float max_y = -INFINITY, max_sig = -INFINITY;
  for (int m = tid; m < p.M; m += kThreads) {
    const float* x = s_pts + m * p.F;
    // forest_mu_sigma: left-to-right chain over trees, then a second pass
    // (the descent again, cheaper than holding B predictions) for the
    // fenced squared deviations.
    float acc = predict(s_feat, s_thr, s_leaf, x, 0, p.D, p.W, p.L);
    for (int b = 1; b < p.B; ++b)
      acc = acc + predict(s_feat, s_thr, s_leaf, x, b, p.D, p.W, p.L);
    s_acc[m] = acc;
    float mu = acc * inv_b;
    float dev = predict(s_feat, s_thr, s_leaf, x, 0, p.D, p.W, p.L) - mu;
    float acc2 = nc(dev * dev);
    for (int b = 1; b < p.B; ++b) {
      dev = predict(s_feat, s_thr, s_leaf, x, b, p.D, p.W, p.L) - mu;
      acc2 = acc2 + nc(dev * dev);
    }
    float sigma = maxf(sqrtf(acc2 * inv_b), floor_);
    const float y = p.y[ro + m];
    if (p.cens != nullptr && p.cens[ro + m]) {
      mu = maxf(mu, y);
      sigma = maxf(sigma, p.cens_rel * fabsf(y));
    }
    s_mu[m] = mu;
    s_sig[m] = sigma;
    const bool obs = p.obs[ro + m] != 0;
    const bool untested = !obs && (p.valid == nullptr || p.valid[m] != 0);
    if (obs) max_y = maxf(max_y, y);
    if (untested) max_sig = maxf(max_sig, sigma);
  }
  // y* = best feasible, else max observed y + 3 * max untested sigma.
  for (int o = 16; o > 0; o >>= 1) {
    max_y = maxf(max_y, __shfl_xor_sync(0xffffffffu, max_y, o));
    max_sig = maxf(max_sig, __shfl_xor_sync(0xffffffffu, max_sig, o));
  }
  if ((tid & 31) == 0) {
    red_a[tid >> 5] = max_y;
    red_b[tid >> 5] = max_sig;
  }
  __syncthreads();
  if (tid == 0) {
    float my = red_a[0], ms = red_b[0];
    for (int w = 1; w < kWarps; ++w) {
      my = maxf(my, red_a[w]);
      ms = maxf(ms, red_b[w]);
    }
    const float bf = p.bf[s];
    s_ystar = isfinite(bf) ? bf : my + nc(3.0f * ms);
  }
  __syncthreads();
  const float ystar = s_ystar;
  const float beta = p.beta[s];
  const bool contract = p.cens == nullptr;

  float best = -INFINITY;
  int best_i = 0x7fffffff;
  int any_cand = 0;
  for (int m = tid; m < p.M; m += kThreads) {
    const float mu = s_mu[m], sigma = s_sig[m], acc = s_acc[m];
    const float eic = ei_constrained(mu, acc, inv_b, contract, sigma, ystar,
                                     p.u[m], t_max);
    s_eic[m] = eic;
    bool cand = p.obs[ro + m] == 0 && (p.valid == nullptr || p.valid[m] != 0);
    if (p.use_budget)
      cand = cand && (minus_mu(beta, mu, acc, inv_b, contract)
                      / maxf(sigma, kSigEps) >= p.conf_q);
    any_cand |= cand ? 1 : 0;
    const float raw = p.score_ratio ? eic / maxf(mu, kRatioEps) : eic;
    const float score = quantize(cand ? raw : -INFINITY, 12);
    if (better(score, m, best, best_i)) {
      best = score;
      best_i = m;
    }
    if (p.emit_full) {
      p.mu[ro + m] = mu;
      p.sigma[ro + m] = sigma;
      p.eic[ro + m] = eic;
      p.cand[ro + m] = cand ? 1 : 0;
      if (p.want_nodes) {
        const float step = kSqrt2 * sigma;
        for (int k = 0; k < p.K; ++k)
          p.nodes[(ro + m) * p.K + k] = mu + nc(step * p.xi[k]);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (better(ob, oi, best, best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  any_cand = __syncthreads_or(any_cand);
  if ((tid & 31) == 0) {
    red_a[tid >> 5] = best;
    red_i[tid >> 5] = best_i;
  }
  __syncthreads();
  if (tid != 0) return;
  best = red_a[0];
  best_i = red_i[0];
  for (int w = 1; w < kWarps; ++w) {
    if (better(red_a[w], red_i[w], best, best_i)) {
      best = red_a[w];
      best_i = red_i[w];
    }
  }
  const int pick = best_i < p.M ? best_i : 0;
  p.sel[s] = pick;
  p.has[s] = any_cand ? 1 : 0;
  if (p.emit_full) {
    p.ystar[s] = ystar;
    return;
  }
  const float mu = s_mu[pick], sigma = s_sig[pick];
  p.eic_sel[s] = s_eic[pick];
  p.mu_sel[s] = mu;
  p.sig_sel[s] = sigma;
  if (p.want_nodes) {
    const float step = kSqrt2 * sigma;
    for (int k = 0; k < p.K; ++k)
      p.nodes[static_cast<size_t>(s) * p.K + k] = mu + nc(step * p.xi[k]);
  }
}

}  // namespace

extern "C" size_t select_step_smem_bytes(int B, int D, int W, int L, int M,
                                         int F) {
  return sizeof(float) * (static_cast<size_t>(B) * D * W * 2
                          + static_cast<size_t>(B) * L
                          + static_cast<size_t>(M) * F
                          + static_cast<size_t>(M) * 4);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  Optional inputs (cens, valid, xi) and the outputs of the mode
// not requested are null.
extern "C" int select_step_launch(
    const int* feat, const float* thr, const float* leaf, const float* y,
    const uint8_t* obs, const uint8_t* cens, const float* beta,
    const float* bf, const float* points, const float* u,
    const uint8_t* valid, const float* xi, const float* scal, float conf_q,
    float cens_rel, int S, int B, int D, int W, int L, int M, int F, int K,
    int score_ratio, int use_budget, int emit_full, int want_nodes,
    float* mu, float* sigma, float* eic, float* ystar, uint8_t* cand,
    int* sel, uint8_t* has, float* nodes, float* eic_sel, float* mu_sel,
    float* sig_sel, void* stream) {
  Params p{feat, thr, leaf, y, obs, cens, beta, bf, points, u, valid, xi,
           scal, conf_q, cens_rel, S, B, D, W, L, M, F, K, score_ratio,
           use_budget, emit_full, want_nodes, mu, sigma, eic, ystar, cand,
           sel, has, nodes, eic_sel, mu_sel, sig_sel};
  const size_t smem = select_step_smem_bytes(B, D, W, L, M, F);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        select_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (S > 0) {
    select_step_kernel<<<S, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

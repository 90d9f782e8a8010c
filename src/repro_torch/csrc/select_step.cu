// Fused Lynceus selector step for Hopper (sm_90a): a persistent grid in
// which each group of warps walks over speculative states, one descent per
// (point, tree).
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
// [S,B,D,W], leaf [S,B,L], y/obs/cens [S,M]): ~6 us of HBM time.  What the
// card spends is issue: 53 M node visits, each a dependent chain of two
// shared-memory loads, and some 250 instructions of EI_c a point.  The
// design (kernel.py's `plan` picks the geometry):
//   * one descent per (point, tree): the B trees descend side by side,
//     level by level (B independent chains a thread), and their B
//     predictions stay in registers, where both chains of forest_mu_sigma
//     read them (NB, the tree count, is a template parameter);
//   * one 8-byte (feature, threshold) load a level: each state's forest is
//     repacked in shared memory as a heap of pairs, leaves included, and a
//     descent step is a load of the pair, an add, a load of the point's
//     feature from the points tile (feature-major, so that the lanes of a
//     warp read neighbouring words), a compare and the child's address;
//   * points resident, states streamed: a block loads the points tile, the
//     unit prices and the validity mask once, and each of its groups walks
//     over states with a stride of the grid's group count; the next
//     state's forest and y/obs/cens rows (contiguous in device memory) come
//     into a second shared buffer by `cp.async` while the current state is
//     computed;
//   * lanes per state from S: a group of `wps` warps takes one state; its
//     reductions (y*'s two maxima, the argmax) are shuffles, and across the
//     group's warps one named barrier each (`bar.sync` with the group's
//     id), never a block barrier.  At S = 1 one group of up to 12 warps
//     takes the one state.
//
// Arithmetic contract (what makes the kernel equal its plain version):
// built with -fmad=false (no product contracted into an FMA but the
// explicit __fmaf_rn of minus_mu and of the root nodes, which reproduce
// the contractions of the forest mean that the reference's compiled
// program makes), IEEE
// division and square root (-prec-div=true -prec-sqrt=true, never
// --use_fast_math) and -ftz=true (float32 subnormals flush to zero, as the
// reference's XLA CPU backend computes and the plain version emulates).
// Every float operation below is the same operation, in the same order, as
// the plain version's.  The reductions' order is free: the argmax (lowest
// index on ties) gives one answer in any order, and y*'s maxima can differ
// only in the sign of a zero maximum, which y* = max_y + 3·max_sigma
// (max_sigma >= +0, or -inf) does not show.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kMaxThreads = 384;
constexpr int kMinBlocks = 2;      // two blocks an SM: at most 85 registers
constexpr int kMaxTrees = 16;
constexpr int kMaxGroups = 15;     // named barriers 1..15, one per group

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
  const float* sig_floor;   // [S]: each state's sigma floor
  float conf_q, cens_rel;
  int S, B, D, W, L, M, F, K;
  int score_ratio, use_budget, emit_full, want_nodes;
  int wps, groups;
  float* mu; float* sigma; float* eic; float* ystar; uint8_t* cand;
  int* sel; uint8_t* has; float* nodes; float* nodes_y;
  float* eic_sel; float* mu_sel; float* sig_sel;
};

// Byte offsets in a block's dynamic shared memory.  kernel.py's
// `smem_bytes` computes the same total; the launcher checks it.
struct Layout {
  int pts, u, valid;          // block-resident: points [F][M], u, valid
  int group0, group_bytes;    // then one area per group:
  int stage_bytes;            //   two stage buffers, each
  int st_feat, st_thr, st_leaf, st_y, st_obs, st_cens;
  int nodes, acc, sig, red;   //   then the repacked forest and scratch
  int total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout make_layout(int B, int D, int W, int L,
                                              int M, int F, bool cens,
                                              int wps, int groups) {
  Layout l;
  int off = 0;
  l.pts = off;   off += align16(M * F * 4);
  l.u = off;     off += align16(M * 4);
  l.valid = off; off += align16(M);
  l.group0 = off;
  int so = 0;
  l.st_feat = so; so += align16(B * D * W * 4);
  l.st_thr = so;  so += align16(B * D * W * 4);
  l.st_leaf = so; so += align16(B * L * 4);
  l.st_y = so;    so += align16(M * 4);
  l.st_obs = so;  so += align16(M);
  l.st_cens = so; so += cens ? align16(M) : 0;
  l.stage_bytes = so;
  int go = 2 * so;
  l.nodes = go; go += align16(B * ((2 << D) - 1) * 8);
  l.acc = go;   go += align16(M * 4);
  l.sig = go;   go += align16(M * 4);
  l.red = go;   go += wps * 32;      // per warp: 2 maxima, argmax, any
  l.group_bytes = go;
  l.total = off + groups * go;
  return l;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One state row (`nbytes` contiguous bytes) into shared memory by the
// group's lanes: cp.async in the widest chunk that the source address and
// the length allow (the destination is 16-byte aligned); a row of odd
// bytes (a bool row of odd M) is copied by plain loads.
__device__ __forceinline__ void copy_row(unsigned char* dst,
                                         const void* src_v, int nbytes,
                                         int lane, int lanes) {
  const unsigned char* src = static_cast<const unsigned char*>(src_v);
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src))
                     | static_cast<unsigned>(nbytes);
  if ((a & 15u) == 0) {
    for (int i = lane * 16; i < nbytes; i += lanes * 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_u32(dst + i)), "l"(src + i) : "memory");
  } else if ((a & 7u) == 0) {
    for (int i = lane * 8; i < nbytes; i += lanes * 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                   :: "r"(smem_u32(dst + i)), "l"(src + i) : "memory");
  } else if ((a & 3u) == 0) {
    for (int i = lane * 4; i < nbytes; i += lanes * 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_u32(dst + i)), "l"(src + i) : "memory");
  } else {
    for (int i = lane; i < nbytes; i += lanes) dst[i] = src[i];
  }
}

// Loads from a 32-bit shared-memory address (`off` a constant offset),
// so that a descent step is one address add and its loads.
template <int off>
__device__ __forceinline__ int2 lds64(uint32_t addr) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2+%3];\n"
               : "=r"(v.x), "=r"(v.y) : "r"(addr), "n"(off));
  return v;
}

template <int off>
__device__ __forceinline__ float lds32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];\n"
               : "=f"(v) : "r"(addr), "n"(off));
  return v;
}

// One level of the NB trees' descents (bs = 0..NB-1), the trees' steps
// side by side: every tree's node pair, then the point's feature that each
// names, then each compare and child entry.
template <int NB, int... bs>
__device__ __forceinline__ void descend_level(
    uint32_t* hb, uint32_t xm, uint32_t k2,
    std::integer_sequence<int, bs...>) {
  int2 nd[NB];
  float x[NB];
  ((nd[bs] = lds64<bs * 8>(hb[bs])), ...);
  ((x[bs] = lds32<0>(xm + static_cast<uint32_t>(nd[bs].x))), ...);
  ((hb[bs] = 2 * hb[bs] + k2
             + (x[bs] > __int_as_float(nd[bs].y) ? NB * 8u : 0u)), ...);
}

// The leaf values the NB descents ended at.
template <int... bs>
__device__ __forceinline__ void read_leaves(const uint32_t* hb, float* pred,
                                            std::integer_sequence<int, bs...>) {
  ((pred[bs] = lds32<bs * 8>(hb[bs])), ...);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Barrier of one group: the warp's own for a one-warp group, else the
// group's named barrier.
__device__ __forceinline__ void group_sync(int id, int lanes) {
  if (lanes == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(lanes) : "memory");
  }
}

// State s's inputs into stage buffer `st`.
__device__ __forceinline__ void issue_state(const Params& p, const Layout& l,
                                            unsigned char* st, int s,
                                            int lane, int lanes) {
  const size_t nodes = static_cast<size_t>(p.B) * p.D * p.W;
  const size_t row = static_cast<size_t>(s);
  copy_row(st + l.st_feat, p.feat + row * nodes,
           static_cast<int>(nodes * 4), lane, lanes);
  copy_row(st + l.st_thr, p.thr + row * nodes,
           static_cast<int>(nodes * 4), lane, lanes);
  copy_row(st + l.st_leaf, p.leaf + row * p.B * p.L, p.B * p.L * 4, lane,
           lanes);
  copy_row(st + l.st_y, p.y + row * p.M, p.M * 4, lane, lanes);
  copy_row(st + l.st_obs, p.obs + row * p.M, p.M, lane, lanes);
  if (p.cens != nullptr)
    copy_row(st + l.st_cens, p.cens + row * p.M, p.M, lane, lanes);
  cp_async_commit();
}

template <int NB>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
select_step_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = make_layout(NB, p.D, p.W, p.L, p.M, p.F,
                               p.cens != nullptr, p.wps, p.groups);
  const int lanes = p.wps * 32;
  const int gib = threadIdx.x / lanes;         // group in the block
  const int lane = threadIdx.x % lanes;        // lane in the group
  const int M = p.M;
  const int nt = (1 << p.D) - 1;               // internal nodes a tree
  float* s_pts = reinterpret_cast<float*>(smem + l.pts);
  float* s_u = reinterpret_cast<float*>(smem + l.u);
  uint8_t* s_valid = smem + l.valid;
  unsigned char* g = smem + l.group0 + gib * l.group_bytes;
  int2* s_heap = reinterpret_cast<int2*>(g + l.nodes);
  const uint32_t heap_u32 = smem_u32(s_heap);
  const uint32_t pts_u32 = smem_u32(s_pts);
  float* s_acc = reinterpret_cast<float*>(g + l.acc);
  float* s_sig = reinterpret_cast<float*>(g + l.sig);
  float* red = reinterpret_cast<float*>(g + l.red);   // [wps][8]
  int* red_i = reinterpret_cast<int*>(g + l.red);
  const int bar = 1 + gib;

  // Group g of block b starts at state g·grid + b and strides by the
  // grid's group count: the states left over after whole rounds fall to
  // the first group of every block, spread over the SMs.
  const int n_groups = gridDim.x * p.groups;
  int s = gib * gridDim.x + blockIdx.x;
  if (s < p.S) issue_state(p, l, g, s, lane, lanes);
  // The block-resident tiles, while the first states arrive.
  for (int i = threadIdx.x; i < M * p.F; i += blockDim.x) {
    const int m = i / p.F;
    s_pts[(i - m * p.F) * M + m] = p.points[i];
  }
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    s_u[i] = p.u[i];
    s_valid[i] = p.valid == nullptr ? 1 : p.valid[i];
  }
  __syncthreads();

  const float t_max = p.scal[0];
  // The reference's acc / B compiles to acc * f32(1/B) (XLA rewrites a
  // division by a constant into a product with its reciprocal).
  const float inv_b = 1.0f / static_cast<float>(NB);
  const bool contract = p.cens == nullptr;
  const int warp = lane >> 5;

  for (int it = 0; s < p.S; ++it, s += n_groups) {
    unsigned char* st = g + (it & 1) * l.stage_bytes;
    // Each state's own sigma floor (a launch may hold several runs' states).
    const float floor_ = p.sig_floor[s];
    cp_async_wait_all();
    group_sync(bar, lanes);
    // Repack the forest as a heap, tree-minor (entry h·NB + b): internal
    // node h = 2^lvl - 1 + pos as (byte offset of its feature's row in the
    // points tile, threshold bits), leaf h = nt + pos as (value bits, 0).
    const int* st_feat = reinterpret_cast<const int*>(st + l.st_feat);
    const float* st_thr = reinterpret_cast<const float*>(st + l.st_thr);
    const float* st_leaf = reinterpret_cast<const float*>(st + l.st_leaf);
    for (int i = lane; i < NB * (2 * nt + 1); i += lanes) {
      const int h = i / NB, b = i - h * NB;
      if (h < nt) {
        const int lvl = 31 - __clz(h + 1);
        const int src = (b * p.D + lvl) * p.W + (h + 1 - (1 << lvl));
        s_heap[i] = make_int2(st_feat[src] * M * 4,
                              __float_as_int(st_thr[src]));
      } else {
        s_heap[i] = make_int2(__float_as_int(st_leaf[b * p.L + h - nt]), 0);
      }
    }
    if (s + n_groups < p.S)
      issue_state(p, l, g + ((it + 1) & 1) * l.stage_bytes, s + n_groups,
                  lane, lanes);
    group_sync(bar, lanes);

    const float* yrow = reinterpret_cast<const float*>(st + l.st_y);
    const uint8_t* obs = st + l.st_obs;
    const uint8_t* cens = p.cens != nullptr ? st + l.st_cens : nullptr;

    // Pass 1: the forest's mean and spread at each of the lane's points.
    float max_y = -INFINITY, max_sig = -INFINITY;
    // Each tree's heap entry as a shared address: hb = heap + h·NB·8, so
    // the child 2h + 1 + (x > thr) is hb·2 + k2 (+ NB·8 going right).
    const uint32_t k2 = NB * 8 - heap_u32;
    for (int m = lane; m < M; m += lanes) {
      const uint32_t xm = pts_u32 + 4 * m;     // feature f at xm + f·M·4
      uint32_t hb[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) hb[b] = heap_u32;
      for (int lvl = 0; lvl < p.D; ++lvl)
        descend_level<NB>(hb, xm, k2, std::make_integer_sequence<int, NB>());
      float pred[NB];
      read_leaves(hb, pred, std::make_integer_sequence<int, NB>());
      // forest_mu_sigma: left-to-right chains over the trees.
      float acc = pred[0];
#pragma unroll
      for (int b = 1; b < NB; ++b) acc = acc + pred[b];
      const float mu = acc * inv_b;
      float dev = pred[0] - mu;
      float acc2 = nc(dev * dev);
#pragma unroll
      for (int b = 1; b < NB; ++b) {
        dev = pred[b] - mu;
        acc2 = acc2 + nc(dev * dev);
      }
      float sigma = maxf(sqrtf(acc2 * inv_b), floor_);
      const float y = yrow[m];
      if (cens != nullptr && cens[m])
        sigma = maxf(sigma, p.cens_rel * fabsf(y));
      s_acc[m] = acc;
      s_sig[m] = sigma;
      const bool ob = obs[m] != 0;
      if (ob) max_y = maxf(max_y, y);
      if (!ob && s_valid[m]) max_sig = maxf(max_sig, sigma);
    }
    // y* = best feasible, else max observed y + 3 * max untested sigma.
    for (int o = 16; o > 0; o >>= 1) {
      max_y = maxf(max_y, __shfl_xor_sync(0xffffffffu, max_y, o));
      max_sig = maxf(max_sig, __shfl_xor_sync(0xffffffffu, max_sig, o));
    }
    if (lanes > 32) {
      if ((lane & 31) == 0) {
        red[warp * 8 + 0] = max_y;
        red[warp * 8 + 1] = max_sig;
      }
      group_sync(bar, lanes);
      max_y = red[0];
      max_sig = red[1];
      for (int w = 1; w < p.wps; ++w) {
        max_y = maxf(max_y, red[w * 8 + 0]);
        max_sig = maxf(max_sig, red[w * 8 + 1]);
      }
    } else {
      __syncwarp();     // s_acc / s_sig written by other lanes
    }
    const float bf = p.bf[s];
    const float ystar = isfinite(bf) ? bf : max_y + nc(3.0f * max_sig);
    const float beta = p.beta[s];
    const size_t ro = static_cast<size_t>(s) * M;

    // Pass 2: EI_c, the candidate mask, the score and its argmax.
    float best = -INFINITY, best_eic = 0.0f;
    int best_i = 0x7fffffff;
    bool any_cand = false;
    for (int m = lane; m < M; m += lanes) {
      const float acc = s_acc[m], sigma = s_sig[m];
      float mu = acc * inv_b;
      if (cens != nullptr && cens[m]) mu = maxf(mu, yrow[m]);
      const float eic = ei_constrained(mu, acc, inv_b, contract, sigma,
                                       ystar, s_u[m], t_max);
      bool cand = obs[m] == 0 && s_valid[m] != 0;
      if (p.use_budget)
        cand = cand && (minus_mu(beta, mu, acc, inv_b, contract)
                        / maxf(sigma, kSigEps) >= p.conf_q);
      any_cand |= cand;
      const float raw = p.score_ratio ? eic / maxf(mu, kRatioEps) : eic;
      const float score = quantize(cand ? raw : -INFINITY, 12);
      if (better(score, m, best, best_i)) {
        best = score;
        best_i = m;
        best_eic = eic;
      }
      if (p.emit_full) {
        p.mu[ro + m] = mu;
        p.sigma[ro + m] = sigma;
        p.eic[ro + m] = eic;
        p.cand[ro + m] = cand ? 1 : 0;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      const float oe = __shfl_xor_sync(0xffffffffu, best_eic, o);
      if (better(ob, oi, best, best_i)) {
        best = ob;
        best_i = oi;
        best_eic = oe;
      }
    }
    any_cand = __any_sync(0xffffffffu, any_cand);
    if (lanes > 32) {
      if ((lane & 31) == 0) {
        red[warp * 8 + 2] = best;
        red_i[warp * 8 + 3] = best_i;
        red[warp * 8 + 4] = best_eic;
        red[warp * 8 + 5] = any_cand ? 1.0f : 0.0f;
      }
      group_sync(bar, lanes);
      if (lane == 0) {
        for (int w = 0; w < p.wps; ++w) {
          const int wi = red_i[w * 8 + 3];
          if (better(red[w * 8 + 2], wi, best, best_i)) {
            best = red[w * 8 + 2];
            best_i = wi;
            best_eic = red[w * 8 + 4];
          }
          any_cand |= red[w * 8 + 5] != 0.0f;
        }
      }
    }
    // The pick's index, from lane 0 to the group (its outputs below).
    int pick = best_i < M ? best_i : 0;
    if (lane == 0) {
      p.sel[s] = pick;
      p.has[s] = any_cand ? 1 : 0;
    }
    if (p.emit_full) {
      if (lane == 0) p.ystar[s] = ystar;
      if (p.want_nodes) {
        // nodes: mu + step·xi.  nodes_y, the children's speculated y: the
        // same with the forest mean's product contracted into the addition
        // where mu is the raw mean (as minus_mu does).  Written in the
        // outputs' [M, K] order, neighbouring lanes on neighbouring words.
        for (int i = lane; i < M * p.K; i += lanes) {
          const int m = i / p.K, k = i - m * p.K;
          const float acc = s_acc[m], sigma = s_sig[m];
          float mu = acc * inv_b;
          if (cens != nullptr && cens[m]) mu = maxf(mu, yrow[m]);
          const float d = nc((kSqrt2 * sigma) * p.xi[k]);
          p.nodes[ro * p.K + i] = mu + d;
          p.nodes_y[ro * p.K + i] =
              contract ? __fmaf_rn(acc, inv_b, d) : mu + d;
        }
      }
    } else if (lane == 0) {
      const float acc = s_acc[pick], sigma = s_sig[pick];
      float mu = acc * inv_b;
      if (cens != nullptr && cens[pick]) mu = maxf(mu, yrow[pick]);
      p.eic_sel[s] = best_eic;
      p.mu_sel[s] = mu;
      p.sig_sel[s] = sigma;
      if (p.want_nodes) {
        const float step = kSqrt2 * sigma;
        for (int k = 0; k < p.K; ++k)
          p.nodes[static_cast<size_t>(s) * p.K + k] = mu + nc(step * p.xi[k]);
      }
    }
  }
}

using KernelFn = void (*)(Params);

// The instantiation for B trees (1 <= B <= kMaxTrees), else null.
KernelFn kernel_for(int B) {
  switch (B) {
#define SELECT_STEP_CASE(n) \
    case n:                 \
      return select_step_kernel<n>;
    SELECT_STEP_CASE(1) SELECT_STEP_CASE(2) SELECT_STEP_CASE(3)
    SELECT_STEP_CASE(4) SELECT_STEP_CASE(5) SELECT_STEP_CASE(6)
    SELECT_STEP_CASE(7) SELECT_STEP_CASE(8) SELECT_STEP_CASE(9)
    SELECT_STEP_CASE(10) SELECT_STEP_CASE(11) SELECT_STEP_CASE(12)
    SELECT_STEP_CASE(13) SELECT_STEP_CASE(14) SELECT_STEP_CASE(15)
    SELECT_STEP_CASE(16)
#undef SELECT_STEP_CASE
    default:
      return nullptr;
  }
}

}  // namespace

// Registers a thread and local (spill) bytes of the instantiation for B
// trees; returns the CUDA error (0 on success).
extern "C" int select_step_attributes(int B, int* regs, int* local_bytes) {
  const KernelFn fn = kernel_for(B);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

// Launches on `stream` with the geometry of kernel.py's `plan` (grid
// blocks of `threads` = groups · wps · 32 threads and `smem` bytes of
// dynamic shared memory); returns cudaGetLastError() after the launch (0
// on success), or cudaErrorInvalidValue for a geometry the kernel does not
// take.  scal [1] is t_max, sig_floor [S] each state's sigma floor.
// Optional inputs (cens, valid, xi) and the outputs of the mode not
// requested are null.
extern "C" int select_step_launch(
    const int* feat, const float* thr, const float* leaf, const float* y,
    const uint8_t* obs, const uint8_t* cens, const float* beta,
    const float* bf, const float* points, const float* u,
    const uint8_t* valid, const float* xi, const float* scal,
    const float* sig_floor, float conf_q, float cens_rel, int S, int B,
    int D, int W, int L, int M, int F, int K,
    int score_ratio, int use_budget, int emit_full, int want_nodes,
    int grid, int threads, int wps, int groups, int smem,
    float* mu, float* sigma, float* eic, float* ystar, uint8_t* cand,
    int* sel, uint8_t* has, float* nodes, float* nodes_y, float* eic_sel,
    float* mu_sel, float* sig_sel, void* stream) {
  const KernelFn fn = kernel_for(B);
  const Layout lay = make_layout(B, D, W, L, M, F, cens != nullptr, wps,
                                 groups);
  if (fn == nullptr || M < 1 || wps < 1 || groups < 1
      || groups > kMaxGroups || threads != groups * wps * 32
      || threads > kMaxThreads || lay.total > smem)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{feat, thr, leaf, y, obs, cens, beta, bf, points, u, valid, xi,
           scal, sig_floor, conf_q, cens_rel, S, B, D, W, L, M, F, K,
           score_ratio, use_budget, emit_full, want_nodes, wps, groups, mu,
           sigma, eic, ystar, cand, sel, has, nodes, nodes_y, eic_sel,
           mu_sel, sig_sel};
  // The opt-in above 48 KB, once per instantiation and size.
  static int opted[kMaxTrees] = {};
  if (smem > 48 * 1024 && smem > opted[B - 1]) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[B - 1] = smem;
  }
  if (S > 0) {
    fn<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

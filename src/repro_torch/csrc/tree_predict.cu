// Bagged-forest inference for Hopper (sm_90a): ensemble mean and spread
// of one forest over M query points, one descent per (point, tree).
//
// Replaces the TPU kernel `tree_predict_call` / `_kernel` of
// src/repro/kernels/tree_predict/kernel.py (pallas_call at line 88).  For
// every point it descends the B complete binary trees of depth D (node id
// `pos % W` at every level, an +inf threshold routes left), and writes
// mu = mean of the B leaf values and sigma = max(sqrt(var), floor).  The
// plain PyTorch version is src/repro_torch/kernels/tree_predict/ref.py,
// and `tree_predict_held` there is this kernel's order in plain PyTorch.
//
// Bound on the H100: bytes at scale (28 bytes a point at F = 5: x read,
// mu and sigma written; 0.0088 ms at M = 1 << 20), a launch's latency at
// the Lynceus shapes (M = 384, B = 10 trees of depth 4: 11 KB).  What the
// design does about each:
// - Parallel over trees as well as points.  A block takes tiles of
//   `tile` points (a power of two, kernel.py's `plan`) and its threads
//   take the tile's (point, tree) pairs, a thread one point and every
//   (threads / tile)-th tree, so M = 384 with B = 10 fills 48 blocks of
//   80 pairs, not 3 blocks of a thread a point, and each thread's chain
//   of dependent loads is one descent of D levels (unrolled for D <= 8).
// - Each point is descended once per tree.  Its B predictions are held in
//   shared memory ([B, tile]), and one thread a point takes the mean and
//   then the two-pass deviation from them in tree order: the plain
//   version's cancellation-free spread (the TPU kernel's one-pass
//   E[p^2] - mu^2 cancels when |mu| >> sigma, where a forest's trees
//   agree) without a second descent.  Where a thread holds all B trees of
//   its point (threads == tile, as at scale), it sums the mean as the
//   predictions come, two descents in flight, and needs no barrier.
// - No level reads global memory.  The tile's rows are staged in shared
//   memory by a coalesced copy (float4 where the row block is aligned),
//   feature-major ([F, tile]: a warp's points read distinct banks
//   whatever features their nodes name), and the forest is packed once a
//   block as a heap of 8-byte
//   (feature, threshold) nodes, one load a level, with the node of heap
//   position 2^l - 1 + pos taken from `pos % W` of level l and every
//   infinite threshold stored as +inf (x > +inf is false for every x, so
//   the descent needs no isinf test).
// - The grid is at most the blocks the card holds at once; a block walks
//   its tiles with the forest packed once.
// At scale the descents bind, not the bytes: two dependent shared loads a
// level (the node, then x[feature]) and the instructions between them
// (the unrolled levels of a depth's instantiation matter), plus the leaf,
// the held prediction and its read-back (PERF.md, kernel table).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__host__ __device__ __forceinline__ size_t a16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Element e of a tile's row block (row-major [rows, F]) goes to
// s_x[f * tile + r]: feature-major, so that a warp's 32 points read 32
// banks whatever features their nodes name.
// The row r = e / F is taken as (e + 1/2) · (1/F) rounded down, exact
// while e < 2^23 and its float error stays below 1/(2F): a block's rows
// hold fewer than 2^16 elements.
__device__ __forceinline__ void put(float* s_x, int e, float v, int F,
                                    float inv_f, int log_tile) {
  const int r = __float2int_rz((static_cast<float>(e) + 0.5f) * inv_f);
  s_x[((e - r * F) << log_tile) + r] = v;
}

// kDepth >= 0 fixes the depth (the levels unroll); -1 reads `D`.
template <int kDepth>
__global__ void __launch_bounds__(kMaxThreads)
tree_predict_kernel(const float* __restrict__ x, const int* __restrict__ feat,
                    const float* __restrict__ thr,
                    const float* __restrict__ leaf, float sigma_floor, int M,
                    int F, int B, int depth, int W, int log_tile,
                    float* __restrict__ mu, float* __restrict__ sigma) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = kDepth >= 0 ? kDepth : depth;
  const int L = 1 << D;
  const int inner = L - 1;                     // heap nodes a tree
  const int tile = 1 << log_tile;
  int2* s_node = reinterpret_cast<int2*>(smem);
  size_t off = a16(sizeof(int2) * static_cast<size_t>(B) * inner);
  float* s_leaf = reinterpret_cast<float*>(smem + off);
  off += a16(sizeof(float) * static_cast<size_t>(B) * L);
  float* s_x = reinterpret_cast<float*>(smem + off);
  off += a16(sizeof(float) * static_cast<size_t>(tile) * F);
  float* s_pred = reinterpret_cast<float*>(smem + off);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tiles = (M + tile - 1) >> log_tile;
  const float inv_f = 1.0f / static_cast<float>(F);

  for (int i = tid; i < B * inner; i += nthreads) {
    const int b = i / max(inner, 1), k = i - b * inner;
    const int lvl = 31 - __clz(k + 1);
    const int pos = k + 1 - (1 << lvl);
    const int src = (b * D + lvl) * W + pos % W;
    const float t = __ldg(thr + src);
    s_node[i] = make_int2(__ldg(feat + src) << log_tile,
                          __float_as_int(isinf(t) ? INFINITY : t));
  }
  for (int i = tid; i < B * L; i += nthreads) s_leaf[i] = __ldg(leaf + i);

  // Each thread keeps one point of the tile and takes its trees b0,
  // b0 + step, ... (threads are a multiple of the tile).
  const int r = tid & (tile - 1);
  const int b0 = tid >> log_tile, bstep = nthreads >> log_tile;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int start = t << log_tile;
    const int rows = min(tile, M - start);
    const float* xs = x + static_cast<size_t>(start) * F;
    const int n = rows * F;
    if (t != static_cast<int>(blockIdx.x))
      __syncthreads();               // the last tile's reads are done
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(xs) & 15) == 0) {
      head = n & ~3;
      const float4* xs4 = reinterpret_cast<const float4*>(xs);
      for (int i = tid; i < head >> 2; i += nthreads) {
        const float4 v = __ldg(xs4 + i);
        put(s_x, 4 * i, v.x, F, inv_f, log_tile);
        put(s_x, 4 * i + 1, v.y, F, inv_f, log_tile);
        put(s_x, 4 * i + 2, v.z, F, inv_f, log_tile);
        put(s_x, 4 * i + 3, v.w, F, inv_f, log_tile);
      }
    }
    for (int i = head + tid; i < n; i += nthreads)
      put(s_x, i, __ldg(xs + i), F, inv_f, log_tile);
    __syncthreads();                 // rows staged (and the forest packed)

    // The leaf that point r reaches in tree b.
    const float* xr = s_x + r;
    const auto descend = [&](int b) {
      const int2* h = s_node + b * inner;
      int k = 0;
#pragma unroll
      for (int lvl = 0; lvl < D; ++lvl) {
        const int2 nd = h[k];
        k = 2 * k + 1 + (xr[nd.x] > __int_as_float(nd.y));
      }
      return s_leaf[b * L + (k - inner)];
    };
    // Mean and two-pass deviation of point i from the predictions held in
    // s_pred, whose sum in tree order is acc.
    const auto finish = [&](int i, float acc) {
      const float mean = acc / static_cast<float>(B);
      float acc2 = 0.0f;
      for (int b = 0; b < B; ++b) {
        const float d = s_pred[(b << log_tile) + i] - mean;
        acc2 = acc2 + d * d;
      }
      mu[start + i] = mean;
      sigma[start + i] =
          fmaxf(sqrtf(acc2 / static_cast<float>(B)), sigma_floor);
    };
    if (bstep == 1) {
      // The thread holds every tree of its point: it sums the mean as the
      // predictions come (two descents in flight) and reads its own back
      // for the deviation, with no barrier between.
      if (r < rows) {
        float acc = 0.0f;
        int b = 0;
        for (; b + 1 < B; b += 2) {
          const float p0 = descend(b), p1 = descend(b + 1);
          s_pred[(b << log_tile) + r] = p0;
          s_pred[((b + 1) << log_tile) + r] = p1;
          acc = acc + p0;
          acc = acc + p1;
        }
        if (b < B) {
          const float p0 = descend(b);
          s_pred[(b << log_tile) + r] = p0;
          acc = acc + p0;
        }
        finish(r, acc);
      }
    } else {
      if (r < rows)
        for (int b = b0; b < B; b += bstep)
          s_pred[(b << log_tile) + r] = descend(b);
      __syncthreads();
      if (tid < rows) {
        float acc = 0.0f;
        for (int b = 0; b < B; ++b)
          acc = acc + s_pred[(b << log_tile) + tid];
        finish(tid, acc);
      }
    }
  }
}

typedef void (*KernelFn)(const float*, const int*, const float*, const float*,
                         float, int, int, int, int, int, int, float*, float*);

// The instantiation for depth D: unrolled levels up to 8, else the loop.
KernelFn kernel_for(int D) {
  switch (D) {
    case 0: return tree_predict_kernel<0>;
    case 1: return tree_predict_kernel<1>;
    case 2: return tree_predict_kernel<2>;
    case 3: return tree_predict_kernel<3>;
    case 4: return tree_predict_kernel<4>;
    case 5: return tree_predict_kernel<5>;
    case 6: return tree_predict_kernel<6>;
    case 7: return tree_predict_kernel<7>;
    case 8: return tree_predict_kernel<8>;
    default: return tree_predict_kernel<-1>;
  }
}

}  // namespace

// (registers a thread, local bytes) of the kernel for depth D, as the
// loaded module reports them.
extern "C" int tree_predict_attributes(int D, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel_for(D));
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return 0;
}

// Launches `grid` blocks of `threads` threads over tiles of 2^log_tile
// points with `smem` bytes of dynamic shared memory (kernel.py's `plan`)
// on `stream`; returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a geometry the kernel does not
// take.  x [M, F] f32; feat [B, D, W] i32; thr [B, D, W] f32;
// leaf [B, 2^D] f32; mu, sigma [M] f32, all contiguous on the card.
extern "C" int tree_predict_launch(const float* x, const int* feat,
                                   const float* thr, const float* leaf,
                                   float sigma_floor, int M, int F, int B,
                                   int D, int W, int grid, int threads,
                                   int log_tile, int smem, float* mu,
                                   float* sigma, void* stream) {
  if (grid < 1 || threads < 32 || threads > kMaxThreads || threads % 32 ||
      log_tile < 0 || log_tile > 8 || threads % (1 << log_tile) || B < 1 || D < 0 ||
      D > 20 || F < 1 || (D > 0 && W < 1) || M < 0 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t need = a16(sizeof(int2) * static_cast<size_t>(B)
                          * ((1 << D) - 1))
                      + a16(sizeof(float) * static_cast<size_t>(B) << D)
                      + a16(sizeof(float) * (static_cast<size_t>(F)
                                             << log_tile))
                      + a16(sizeof(float) * (static_cast<size_t>(B)
                                             << log_tile));
  if (need != static_cast<size_t>(smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = kernel_for(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (M > 0)
    fn<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        x, feat, thr, leaf, sigma_floor, M, F, B, D, W, log_tile, mu, sigma);
  return static_cast<int>(cudaGetLastError());
}

// GroupNorm (+ optional SiLU) on NCHW bf16 or float32 (the element type a
// template parameter), fp32 statistics and arithmetic: one launch, x read
// once from device memory.  Output in x's type: bf16 rounded once, float32
// not rounded at all.
//
// Replaces gswm/ops/groupnorm.py:185 fused_group_norm (_resident_kernel
// :112, _stats_kernel :138, _apply_kernel :150; pallas_calls :210, :229,
// :243), the JAX package's GroupNorm op over NHWC.  Its numerics:
// per (image, group) fp32 sums s and ss, mean = s / n, var = max(ss / n -
// mean^2, 0), per channel a = rsqrt(var + eps) * weight and b = bias -
// mean * a, y = x * a + b, optionally y * sigmoid(y), rounded to x's dtype
// (groupnorm.py:80-109).
//
// What bounds it on an H100: one read of x and one write, a dozen
// instructions an element, so device-memory bandwidth, provided x is not
// read from device memory a second time.  The statistics of a group need all
// of it before any of it can be normalised, so the group has to wait on chip
// in between.  In NCHW a group is one contiguous run of n = (C / G) * H * W
// elements: in bf16 11.5 KB to 553 KB in the UNet at 768x768, 295 KB to 9.44
// MB in the VAE; twice that in float32.
//
// Design.  One thread block CLUSTER a group (cudaLaunchKernelEx with the
// cluster dimension attribute; 1 to 16 blocks, above 8 with the non-portable
// size allowed).  Each block of the cluster takes one slice of the group:
//   1. it brings what fits of its slice (55 to 220 KB, `Sizing` below) into
//      its own shared memory
//      with bulk asynchronous copies (cp.async.bulk, one thread issues them,
//      each chunk completing on its own mbarrier: the whole slice is in
//      flight at once, which one block an SM could not do with loads into
//      registers) and sums s and ss in fp32 from shared memory as the chunks
//      land (per thread, warp shuffles, then across warps);
//   2. it leaves its two sums in shared memory; after a cluster barrier
//      every block reads all the cluster's sums through distributed shared
//      memory and adds them in the same fixed tree, so every block has the
//      same total and the result is the same on every run (no atomics);
//   3. it normalises its slice from shared memory and writes it.
// A cluster's blocks are co-resident by construction, so the barrier cannot
// deadlock however many groups the grid holds.  The cluster size is chosen
// per shape: as small as lets the slice fit in shared memory, then larger
// while the grid has fewer blocks than the card has SMs and the slices stay
// above MIN_SLICE elements (a group a block leaves most of 132 SMs idle at
// B * G = 32 ... 128).
//
// A group above 16 slices of 220 KB (3.6 MB: the VAE's 4.72 and 9.44 MB
// groups) does not fit on chip, and a block sized smaller keeps less.  Its blocks keep the head of their slice in
// shared memory and read the tail twice: once for the sums, and again right
// after the barrier, tail first, while it is still in L2 (the clusters in
// flight hold 8 x 4.72 MB of the 50 MB).  The head's copies and all stores are
// streaming (evict-first), so they do not push the tails out of L2.  Blocks
// are sized in bytes, so in float32 they keep half as many elements and more
// groups take this route; at (1, 128, 768, 768) a group is 9.44 MB in
// float32, and 8 clusters in flight no longer fit the L2 (first design: the
// cost is measured, not designed away).
//
// When H * W is a multiple of the elements 16 bytes hold (8 bf16, 4 float),
// those consecutive elements share a channel and move as one 16-byte load
// and store, and every group starts on a 16-byte boundary, as the bulk
// copies need; otherwise an element-wise instance with plain loads.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace gswm_hopper;  // bf16, smem_u32, the mbarrier helpers

// chunks, each with its own mbarrier, the kept part of a slice arrives in
constexpr int CHUNKS = 8;
// do not cut a group into slices smaller than this (16 KB) to fill the card
constexpr int MIN_SLICE_BYTES = 16384;
constexpr int MAX_CLUSTER = 16;

// An element type's conversions and its 16-byte vectors of VEC elements.
template <typename E>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ bf16 from_float(float f) { return __float2bfloat16(f); }
};

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float from_float(float f) { return f; }
};

// How a block is sized.  More, smaller blocks an SM overlap one block's
// loads with another's arithmetic and stores (a block's own phases follow one
// another: measured at (1, 128, 768, 768), loading, the barrier with the
// arithmetic, and storing add up), but a cluster has at most 16 blocks, so
// large groups need large blocks to stay on chip, and large clusters of large
// blocks are slow to place: of 16 blocks of 220 KB an H100 of 132 SMs holds 7
// at once, of 110 KB 14, of 55 KB 21.  Measured on an H100 at the GroupNorm
// shapes of the 768x768 path (gswm_torch/tools/compare_kernels.py prints the
// times), by the elements n of a group and the number of groups:
//   * 64 groups or more, up to one an SM, of 80 KB or more: one 220 KB block
//     an SM, a cluster of one or two (gswm_group_norm below);
//   * else four 55 KB blocks an SM while the group fits 16 of them;
//   * two 110 KB blocks up to three times their capacity (the rest is read
//     again from L2);
//   * beyond that one 220 KB block an SM (of the 227 KB a block may have).
struct Sizing {
  int threads;
  int keep;  // bytes of its slice a block keeps in shared memory
};
constexpr Sizing SMALL = {256, 56320};
constexpr Sizing MEDIUM = {512, 112640};
constexpr Sizing LARGE = {1024, 225280};

// (a, b) summed over the block; every thread gets the result.
template <int THREADS>
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 red[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < THREADS / 32 ? red[lane] : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// The moments of 16 bytes of elements, a pair at a time.
__device__ __forceinline__ void add_moments(const uint4& raw, float& s, float& ss, bf16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    s += f.x + f.y;
    ss += f.x * f.x + f.y * f.y;
  }
}

__device__ __forceinline__ void add_moments(const uint4& raw, float& s, float& ss, float) {
  const float2* p = reinterpret_cast<const float2*>(&raw);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s += p[j].x + p[j].y;
    ss += p[j].x * p[j].x + p[j].y * p[j].y;
  }
}

// y, or y * sigmoid(y) with the fast exponential and division: their error
// (a few ulp of fp32) is far below the bf16 rounding of the result and, in
// float32, a few millionths of max |y| at most, and the exact ones would make
// the kernel instruction-bound.
template <bool SILU>
__device__ __forceinline__ float activate(float y) {
  return SILU ? __fdividef(y, 1.0f + __expf(-y)) : y;
}

// The channel (within its group) of the element a thread is at, and a, b of
// y = x * a + b there, followed along a walk in equal steps: a division when
// the walk starts, none a step, and the parameters read again only where the
// channel changes (a channel is H * W elements long).
struct ChannelWalk {
  int c, r, dq, dr, cur;
  float a, b;
  __device__ __forceinline__ ChannelWalk(int i, int step, int hw)
      : c(i / hw), r(i - c * hw), dq(step / hw), dr(step - dq * hw), cur(-1), a(0.0f), b(0.0f) {}
  // weight, bias: the group's first channel's
  __device__ __forceinline__ void affine(const float* weight, const float* bias, float inv,
                                         float mean) {
    if (c != cur) {
      cur = c;
      a = inv * weight[c];
      b = bias[c] - mean * a;
    }
  }
  __device__ __forceinline__ void step(int hw) {
    c += dq;
    r += dr;
    if (r >= hw) {
      r -= hw;
      ++c;
    }
  }
};

// 16 bytes of elements normalised (x * a + b, then the activation)
template <bool SILU>
__device__ __forceinline__ uint4 normalise_vec(const uint4& raw, float a, float b, bf16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 res;
  __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    r[j] = __floats2bfloat162_rn(activate<SILU>(f.x * a + b), activate<SILU>(f.y * a + b));
  }
  return res;
}

template <bool SILU>
__device__ __forceinline__ uint4 normalise_vec(const uint4& raw, float a, float b, float) {
  const float* p = reinterpret_cast<const float*>(&raw);
  uint4 res;
  float* r = reinterpret_cast<float*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = activate<SILU>(p[j] * a + b);
  return res;
}

// `bytes` (a multiple of 16) global -> shared, issued by one thread, completing
// on `bar`; evict-first in L2: the data is read once.
__device__ __forceinline__ void bulk_load_streaming(void* dst, const void* src, uint32_t bytes,
                                                    uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// Split cluster barrier: every thread of every block of the cluster arrives
// once and waits once.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Grid: (B * G) clusters of gridDim.x / (B * G) blocks along x.  n elements a
// group (below 2^31), slice elements a block (a multiple of W, the elements
// of 16 bytes, when VEC), of which the first keep lie in dynamic shared
// memory between the passes.
template <typename E, bool VEC, int THREADS, bool SILU>
__global__ void __launch_bounds__(THREADS)
gn_cluster_kernel(const E* __restrict__ x, const float* __restrict__ weight,
                  const float* __restrict__ bias, E* __restrict__ out, int n, int hw,
                  int cpg, int groups, int slice, int keep, float eps) {
  constexpr int W = Elem<E>::VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* kept = reinterpret_cast<E*>(smem_raw);
  __shared__ float2 part;   // this block's sums, read by the whole cluster
  __shared__ float2 total;  // the group's sums
  __shared__ __align__(8) uint64_t landed[CHUNKS];

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bg = blockIdx.x / cl;
  const int tid = threadIdx.x;
  const E* xg = x + (size_t)bg * n;
  E* og = out + (size_t)bg * n;
  // this block's slice [lo, hi): [lo, mid) stays in shared memory, [mid, hi)
  // is read again; a trailing block of a small group may have none
  const long long lo64 = (long long)rank * slice;
  const int lo = (int)(lo64 < n ? lo64 : n);
  const int hi = (int)(lo64 + slice < n ? lo64 + slice : n);
  const int mid = lo + keep < hi ? lo + keep : hi;

  float s = 0.0f, ss = 0.0f;
  if (VEC) {
    // [lo, mid) in CHUNKS pieces of `piece` elements, a multiple of W
    const int piece = ((mid - lo + CHUNKS - 1) / CHUNKS + W - 1) / W * W;
    if (tid == 0) {
      for (int c = 0; c < CHUNKS; ++c) mbar_init(&landed[c], 1);
      fence_mbar_init();
      for (int c = 0; c < CHUNKS; ++c) {
        const int from = lo + c * piece;
        if (from >= mid) break;
        const uint32_t bytes =
            (uint32_t)((from + piece < mid ? piece : mid - from) * sizeof(E));
        mbar_expect_tx(&landed[c], bytes);
        bulk_load_streaming(kept + (from - lo), xg + from, bytes, &landed[c]);
      }
    }
    __syncthreads();  // the barriers are initialised before anyone waits
    // the tail, which stays in device memory and L2: plain loads, four in
    // flight a thread, while the copies land
    for (int i = mid + tid * W; i < hi; i += THREADS * W * 4) {
      uint4 raw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k * THREADS * W < hi)
          raw[k] = *reinterpret_cast<const uint4*>(xg + i + k * THREADS * W);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k * THREADS * W < hi) add_moments(raw[k], s, ss, E());
    }
    for (int c = 0; c < CHUNKS; ++c) {
      const int from = lo + c * piece;
      if (from >= mid) break;
      const int to = from + piece < mid ? from + piece : mid;
      mbar_wait(&landed[c], 0);
      for (int i = from + tid * W; i < to; i += THREADS * W)
        add_moments(*reinterpret_cast<const uint4*>(kept + (i - lo)), s, ss, E());
    }
  } else {
    for (int i = lo + tid; i < hi; i += THREADS) {
      const E v = xg[i];
      if (i < mid) kept[i - lo] = v;
      const float f = Elem<E>::to_float(v);
      s += f;
      ss += f * f;
    }
  }
  const float2 mine = block_sum2<THREADS>(s, ss);
  if (tid == 0) part = mine;
  cluster.sync();  // every block's sums are written and visible

  if (tid < 32) {
    // lane r reads block r's sums; one fixed tree, the same in every block
    float2 v = make_float2(0.0f, 0.0f);
    if (tid < cl) v = *cluster.map_shared_rank(&part, tid);
#pragma unroll
    for (int o = MAX_CLUSTER / 2; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (tid == 0) total = v;
  }
  __syncthreads();
  // from here on no block reads another's shared memory: arrive now, wait
  // before exit (a block may not leave while its sums can still be read)
  cluster_arrive();

  const float mean = total.x / (float)n;
  const float var = fmaxf(total.y / (float)n - mean * mean, 0.0f);
  const float inv = rsqrtf(var + eps);
  const int c0 = (bg % groups) * cpg;  // first channel of the group
  if (VEC) {
    // the tail first: it was read last and is the likeliest to be in L2
    ChannelWalk tail(mid + tid * W, THREADS * W, hw);
#pragma unroll 4
    for (int i = mid + tid * W; i < hi; i += THREADS * W) {
      tail.affine(weight + c0, bias + c0, inv, mean);
      const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(xg + i));
      __stcs(reinterpret_cast<uint4*>(og + i),
             normalise_vec<SILU>(raw, tail.a, tail.b, E()));
      tail.step(hw);
    }
    ChannelWalk head(lo + tid * W, THREADS * W, hw);
#pragma unroll 2
    for (int i = lo + tid * W; i < mid; i += THREADS * W) {
      head.affine(weight + c0, bias + c0, inv, mean);
      const uint4 raw = *reinterpret_cast<const uint4*>(kept + (i - lo));
      __stcs(reinterpret_cast<uint4*>(og + i),
             normalise_vec<SILU>(raw, head.a, head.b, E()));
      head.step(hw);
    }
  } else {
    for (int i = lo + tid; i < hi; i += THREADS) {
      const int c = c0 + i / hw;
      const float a = inv * weight[c];
      const float f = Elem<E>::to_float(i < mid ? kept[i - lo] : xg[i]);
      og[i] = Elem<E>::from_float(activate<SILU>(f * a + (bias[c] - mean * a)));
    }
  }
  cluster_wait();
}

// The cluster size for groups of n elements, bg of them, in blocks that keep
// `keep` elements: the smallest that lets a slice fit in shared memory, then
// more while the grid is smaller than the card and the slices stay above
// `min_slice` elements.
int pick_cluster(long long n, long long bg, int keep, int max_cluster, int sms, int unit,
                 int min_slice) {
  auto slice_of = [&](int cl) { return ((n + cl - 1) / cl + unit - 1) / unit * unit; };
  int cl = 1;
  while (cl < max_cluster && slice_of(cl) > keep) cl *= 2;
  while (cl < max_cluster && bg * cl < sms && slice_of(2 * cl) >= min_slice) cl *= 2;
  return cl;
}

// SMs of the card, asked once (one card a process).
cudaError_t sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

struct Device {
  int sms = 0;
  int max_cluster = 0;  // 0: not asked yet
};

// keep_bytes: shared memory a block keeps its slice's head in
template <typename E, bool VEC, int THREADS, bool SILU>
cudaError_t launch(int keep_bytes, int cluster, const E* x, const float* w, const float* b,
                   E* out, int B, int C, int HW, int G, float eps, cudaStream_t st) {
  static Device dev;  // one card a process: this instance's attributes are set once
  auto kernel = gn_cluster_kernel<E, VEC, THREADS, SILU>;
  const int keep_elems = keep_bytes / (int)sizeof(E);
  const size_t max_smem = (size_t)keep_bytes;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  if (dev.max_cluster == 0) {
    cudaError_t err = sm_count(&dev.sms);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)max_smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    // the largest cluster of full-shared-memory blocks this card can place
    int cl = MAX_CLUSTER;
    for (; cl > 1; cl /= 2) {
      int clusters = 0;
      attr[0].val.clusterDim.x = cl;
      cfg.gridDim = dim3(cl);
      cfg.dynamicSmemBytes = max_smem;
      if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) == cudaSuccess &&
          clusters > 0)
        break;
      (void)cudaGetLastError();
    }
    dev.max_cluster = cl;
  }
  const int cpg = C / G;
  const long long n = (long long)cpg * HW;
  const long long bg = (long long)B * G;
  const int unit = VEC ? Elem<E>::VEC : 1;
  const int cl = cluster ? cluster
                         : pick_cluster(n, bg, keep_elems, dev.max_cluster, dev.sms, unit,
                                        MIN_SLICE_BYTES / (int)sizeof(E));
  if (n >= (1ll << 31) || bg * cl >= (1ll << 31)) return cudaErrorInvalidValue;
  const int slice = (int)(((n + cl - 1) / cl + unit - 1) / unit * unit);
  const int keep = slice < keep_elems ? slice : keep_elems;
  attr[0].val.clusterDim.x = cl;
  cfg.gridDim = dim3((unsigned)(bg * cl));
  cfg.dynamicSmemBytes = ((size_t)keep * sizeof(E) + 15) / 16 * 16;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, b, out, (int)n, HW, cpg, G, slice, keep,
                            eps);
}

template <typename E, bool VEC, int THREADS>
cudaError_t launch_act(bool silu, int keep_bytes, int cluster, const E* x, const float* w,
                       const float* b, E* out, int B, int C, int HW, int G, float eps,
                       cudaStream_t st) {
  return silu ? launch<E, VEC, THREADS, true>(keep_bytes, cluster, x, w, b, out, B, C, HW, G,
                                              eps, st)
              : launch<E, VEC, THREADS, false>(keep_bytes, cluster, x, w, b, out, B, C, HW, G,
                                               eps, st);
}

// The sizing of gswm_group_norm below, in bytes, for either element type.
template <typename E>
int group_norm(const void* x, const void* weight, const void* bias, void* out, int B, int C,
               int HW, int G, float eps, int act, void* stream) {
  if (B < 1 || C < 1 || HW < 1 || G < 1 || C % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const E* xin = static_cast<const E*>(x);
  E* y = static_cast<E*>(out);
  const float* w = static_cast<const float*>(weight);
  const float* bb = static_cast<const float*>(bias);
  const long long n = (long long)(C / G) * HW;
  const long long bytes = n * (long long)sizeof(E);  // a group's
  const long long bg = (long long)B * G;
  const bool silu = act == 1;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block an SM: with 64 to `sms` groups of 80 KB or more, one or two of
  // the largest blocks a group cover the card in one round of clusters that
  // are cheap to place (a cluster of 4 or more 220 KB blocks is not), and
  // whatever they cannot keep comes back from L2
  const int few = 2 * bg <= sms ? 2 : 1;
  if (HW % Elem<E>::VEC)  // rare (odd image sizes): one element-wise instance
    err = launch_act<E, false, SMALL.threads>(silu, LARGE.keep, 0, xin, w, bb, y, B, C, HW, G,
                                              eps, st);
  else if (bg >= 64 && bg <= sms && bytes >= 81920 && bytes <= 3ll * few * LARGE.keep)
    err = launch_act<E, true, LARGE.threads>(silu, LARGE.keep, few, xin, w, bb, y, B, C, HW, G,
                                             eps, st);
  else if (bytes <= (long long)MAX_CLUSTER * SMALL.keep)
    err = launch_act<E, true, SMALL.threads>(silu, SMALL.keep, 0, xin, w, bb, y, B, C, HW, G,
                                             eps, st);
  else if (bytes <= 3ll * MAX_CLUSTER * MEDIUM.keep)
    err = launch_act<E, true, MEDIUM.threads>(silu, MEDIUM.keep, 0, xin, w, bb, y, B, C, HW, G,
                                              eps, st);
  else
    err = launch_act<E, true, LARGE.threads>(silu, LARGE.keep, 0, xin, w, bb, y, B, C, HW, G,
                                             eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (B, C, HW) bf16, 16-byte aligned; weight, bias: (C,) fp32; act 0 =
// none, 1 = SiLU.  One launch; no scratch memory.
extern "C" int gswm_group_norm(const void* x, const void* weight, const void* bias,
                               void* out, int B, int C, int HW, int G, float eps, int act,
                               void* stream) {
  return group_norm<bf16>(x, weight, bias, out, B, C, HW, G, eps, act, stream);
}

// The same on float32 x and out.
extern "C" int gswm_group_norm_f32(const void* x, const void* weight, const void* bias,
                                   void* out, int B, int C, int HW, int G, float eps, int act,
                                   void* stream) {
  return group_norm<float>(x, weight, bias, out, B, C, HW, G, eps, act, stream);
}

// GroupNorm (+ optional SiLU) on NCHW or channels-minor (NHWC) x, bf16 or
// float32 (the element type a template parameter), fp32 statistics and
// arithmetic: one launch, x read once from device memory while it fits on
// chip.  Output in x's type and layout: bf16 rounded once, float32 not
// rounded at all.
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
// groups) does not fit in a cluster, and a block sized smaller keeps less.
// In bf16 its blocks keep the head of their slice in shared memory and read
// the tail twice: once for the sums, and again right after the barrier, tail
// first, while it is still in L2 (the clusters in flight hold 8 x 4.72 MB of
// the 50 MB).  The head's copies and all stores are streaming (evict-first),
// so they do not push the tails out of L2.  In float32 those groups are
// twice the bytes (9.44 MB at (1, 128, 768, 768)) and 8 clusters' tails no
// longer fit the L2: they take the persistent grid below instead, whose
// blocks, one an SM, keep three or four such groups whole in the card's
// shared memory at once.
//
// Channels-minor x (the JAX op's own NHWC memory, torch.channels_last) takes
// a kernel of its own, gn_slab_kernel below: there a group is cpg channels of
// every pixel, no contiguous run, and the unit a set of blocks shares is a
// slab of whole groups of one image, summed on a cluster where one keeps it.
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

// y or y * sigmoid(y) as `silu` says at run time (the persistent grid
// takes the activation as an argument: one instance fewer a layout and type)
__device__ __forceinline__ float act(bool silu, float y) {
  return silu ? activate<true>(y) : y;
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

// ---------------------------------------------------------------------------
// The persistent grid: float32 NCHW groups larger than a cluster keeps.
//
// A unit is a group (cpg * HW contiguous elements, one pair of sums).  A unit
// is split into slices over P blocks, K units at a time (the slots), one
// block an SM: K * P blocks, launched cooperatively so that they are
// co-resident, walk the units in rounds.  A round, per block:
//   1. the kept head of the slice is already landing in shared memory
//      (bulk copies started during the previous round's stores); a tail the
//      head could not take is read from device memory with an L2 evict-last
//      policy, so that the second read finds it in L2;
//   2. the block's sums go to this block's fixed place in the launch's
//      scratch; the unit's P blocks meet at an integer arrival counter;
//      every block adds the P sums in rank order, so every block has the same
//      totals and the result is the same on every run;
//   3. it normalises the tail (read again, evict-first) and then the head
//      from shared memory, chunk by chunk, and each chunk, once read, takes
//      the next round's bulk copy.
// K and P follow from what fits: every unit of a round kept whole in the
// card's shared memory where it can be; more units a round where their
// tails together stay within L2_TAIL_BYTES.  The sums and the counters are
// each launch's own, scratch from the stream's pool (cudaMallocAsync), the
// counters zeroed on the stream before the launch: grids on two streams at
// once share nothing.

// threads a block
constexpr int GRID_THREADS = 512;
// the most bytes a block keeps: the 227 KB a block may have, less a margin
// for static shared memory
constexpr int GRID_SMEM = 232448 - 1024;
// a unit is not cut into slices smaller than this to spread it over the card
constexpr int GRID_MIN_SLICE_BYTES = 32768;
// the tails of a round's units, read twice, stay within this much of L2
constexpr long long L2_TAIL_BYTES = 16ll << 20;
// slices start on this many bytes; chunks are whole block steps from there
constexpr int GRID_ALIGN = 128;

#ifdef GN_PHASE_STAMPS
// A measurement build only (gswm_torch/tools/gn_phases.py compiles this
// file with -DGN_PHASE_STAMPS): thread 0 of each block adds the clock64
// cycles of each phase of each round (load, reduce, meet, combine, store;
// a __syncthreads before each stamp), then the block's total, its rounds and
// the bytes of x it loaded from global memory (kept copies, tail reads and
// second reads).
constexpr int GN_PHASES = 5;
constexpr int GN_STAMP_BLOCKS = 1024;
__device__ long long gn_phase_cycles[GN_STAMP_BLOCKS][GN_PHASES + 3];
#define GN_STAMP(k)                                                   \
  do {                                                                \
    __syncthreads();                                                  \
    if (tid == 0) {                                                   \
      const long long now = clock64();                                \
      gn_phase_cycles[blockIdx.x][k] += now - stamp_mark;             \
      stamp_mark = now;                                               \
    }                                                                 \
  } while (0)
#define GN_STAMP_BYTES(n)                                             \
  do {                                                                \
    if (tid == 0) gn_phase_cycles[blockIdx.x][GN_PHASES + 2] += (n);  \
  } while (0)
#else
#define GN_STAMP(k) \
  do {              \
  } while (0)
#define GN_STAMP_BYTES(n) \
  do {                    \
  } while (0)
#endif

struct GridPlan {
  long long unit;  // elements of a unit
  int units;       // B * G
  int slots;       // units a round, K
  int blocks;      // blocks a unit, P
  int slice;       // elements of a block's slice of a unit
  int keep;        // of which at most this many stay in shared memory
  int granule;     // chunks are whole granules: block steps
  int hw, cpg, groups;
  float eps;
  // the launch's scratch: the blocks' sums, float2 per (slot, block) in two
  // halves that alternate by round (a block may write round r + 1's sums
  // while another block of its unit still reads round r's), and each slot's
  // meeting point, its arrivals and its passes (zeroed)
  float2* sums;
  unsigned int* arrived;
  unsigned int* passed;
};

// 16 bytes of x as W floats, and back
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8], bf16) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(p[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4], float) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], bf16) {
  uint4 res;
  __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) r[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return res;
}
__device__ __forceinline__ uint4 pack(const float (&f)[4], float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// 16 bytes from device memory, kept in L2 ahead of streamed data: a tail's
// first read, whose second follows after the unit's blocks have met
__device__ __forceinline__ uint4 load_evict_last(const void* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The `blocks` blocks of a unit meet (one thread of each): each arrives on
// the slot's counter once; the last resets it and lets the others pass by
// advancing the slot's pass count, which every block read before arriving.
// Blocks are co-resident (a cooperative launch), so no block waits on one
// that cannot run.
__device__ __forceinline__ void meet(unsigned int* arrived, unsigned int* passed,
                                     unsigned int blocks) {
  const unsigned int seen = load_acquire(passed);
  __threadfence();
  if (atomicAdd(arrived, 1u) == blocks - 1) {
    atomicExch(arrived, 0u);
    __threadfence();
    atomicAdd(passed, 1u);
  } else {
    while (load_acquire(passed) == seen) __nanosleep(64);
  }
  __threadfence();
}

// Grid: K * P blocks of THREADS, block slot * P + rank.  Dynamic shared
// memory: the kept part (at most p.keep elements), `used` chunks of `piece`
// elements in a row, each landing on its own mbarrier once a round, then
// the unit's statistics.
template <typename E, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
gn_grid_kernel(const E* __restrict__ x, const float* __restrict__ weight,
               const float* __restrict__ bias, E* __restrict__ out, GridPlan p, bool silu) {
  constexpr int W = Elem<E>::VEC;  // elements a load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* kept = reinterpret_cast<E*>(smem_raw);
  float2* stats = reinterpret_cast<float2*>(
      smem_raw + ((size_t)p.keep * sizeof(E) + 15) / 16 * 16);  // (mean, 1 / std)
  __shared__ __align__(8) uint64_t landed[CHUNKS];

  const int slot = blockIdx.x / p.blocks;
  const int rank = blockIdx.x - slot * p.blocks;
  const int tid = threadIdx.x;
  const float n = (float)p.cpg * (float)p.hw;
#ifdef GN_PHASE_STAMPS
  const long long stamp_start = clock64();
  long long stamp_mark = stamp_start;
#endif

  // this block's slice of a unit, [lo, hi), the first `kept_n` elements kept
  const long long lo = (long long)rank * p.slice < p.unit ? (long long)rank * p.slice : p.unit;
  const long long hi = lo + p.slice < p.unit ? lo + p.slice : p.unit;
  const int len = (int)(hi - lo);
  const int kept_n = len < p.keep ? len : p.keep;
  // the kept part in `used` chunks of `piece` elements, whole granules
  const int piece = ((kept_n + CHUNKS - 1) / CHUNKS + p.granule - 1) / p.granule * p.granule;
  const int used = piece ? (kept_n + piece - 1) / piece : 0;

  // chunk c of the round that takes unit u (one thread), if there is one
  auto copy_in = [&](long long u, int c) {
    if (u >= p.units) return;
    const int from = c * piece;
    const uint32_t bytes = (uint32_t)((from + piece < kept_n ? piece : kept_n - from) * sizeof(E));
    mbar_expect_tx(&landed[c], bytes);
    bulk_load_streaming(kept + from, x + u * p.unit + lo + from, bytes, &landed[c]);
  };
  if (tid == 0) {
    for (int c = 0; c < used; ++c) mbar_init(&landed[c], 1);
    fence_mbar_init();
    for (int c = 0; c < used; ++c) copy_in(slot, c);
  }
  __syncthreads();

  uint64_t keep_l2;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(keep_l2));

  for (int round = 0;; ++round) {
    const long long u = (long long)round * p.slots + slot;
    if (u >= p.units) break;
    const int par = round & 1;
    float2* const half = p.sums + (size_t)par * p.slots * p.blocks;
    const E* xs = x + u * p.unit + lo;
    E* os = out + u * p.unit + lo;

    // 1. the sums: the tail from device memory, then the head as it lands
    float s = 0.0f, ss = 0.0f;
    for (int q = kept_n / W + tid; q < len / W; q += 4 * THREADS) {
      uint4 raw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (q + k * THREADS < len / W) raw[k] = load_evict_last(xs + (q + k * THREADS) * W, keep_l2);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (q + k * THREADS < len / W) add_moments(raw[k], s, ss, E());
    }
    for (int c = 0; c < used; ++c) {
      const int size = (c + 1) * piece < kept_n ? piece : kept_n - c * piece;
      const E* chunk = kept + c * piece;
      mbar_wait(&landed[c], par);
      for (int v = tid; v < size / W; v += THREADS)
        add_moments(*reinterpret_cast<const uint4*>(chunk + v * W), s, ss, E());
    }
    GN_STAMP_BYTES((long long)(2 * len - kept_n) * (long long)sizeof(E));
    GN_STAMP(0);

    // 2. the block's sums to its place in device memory, then the unit's
    {
      const float2 mine = block_sum2<THREADS>(s, ss);
      if (tid == 0) half[(size_t)slot * p.blocks + rank] = mine;
    }
    __syncthreads();
    GN_STAMP(1);
    if (tid == 0 && p.blocks > 1)
      meet(p.arrived + slot, p.passed + slot, (unsigned int)p.blocks);
    __syncthreads();
    GN_STAMP(2);
    if (tid < 32) {
      // the unit's sums over its blocks in rank order
      const float2* all = half + (size_t)slot * p.blocks;
      float2 v = make_float2(0.0f, 0.0f);
      for (int j = tid; j < p.blocks; j += 32) {
        const float2 t = __ldcg(all + j);
        v.x += t.x;
        v.y += t.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
        v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
      }
      if (tid == 0) {
        const float mean = v.x / n;
        const float var = fmaxf(v.y / n - mean * mean, 0.0f);
        stats[0] = make_float2(mean, rsqrtf(var + p.eps));
      }
    }
    __syncthreads();
    GN_STAMP(3);

    // 3. normalise: the tail, then the head chunk by chunk, each chunk
    // handed to the next round's copy once every thread has read it
    const float mean = stats[0].x, inv = stats[0].y;
    const int c0 = (int)(u % p.groups) * p.cpg;  // the group's first channel
    ChannelWalk tail((int)(lo + kept_n) + tid * W, THREADS * W, p.hw);
#pragma unroll 2
    for (int i = kept_n + tid * W; i < len; i += THREADS * W) {
      tail.affine(weight + c0, bias + c0, inv, mean);
      const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(xs + i));
      __stcs(reinterpret_cast<uint4*>(os + i),
             silu ? normalise_vec<true>(raw, tail.a, tail.b, E())
                  : normalise_vec<false>(raw, tail.a, tail.b, E()));
      tail.step(p.hw);
    }
    for (int c = 0; c < used; ++c) {
      const int from = c * piece;
      const int to = from + piece < kept_n ? from + piece : kept_n;
      const E* chunk = kept + from;
      ChannelWalk head((int)lo + from + tid * W, THREADS * W, p.hw);
#pragma unroll 2
      for (int i = from + tid * W; i < to; i += THREADS * W) {
        head.affine(weight + c0, bias + c0, inv, mean);
        const uint4 raw = *reinterpret_cast<const uint4*>(chunk + (i - from));
        __stcs(reinterpret_cast<uint4*>(os + i),
               silu ? normalise_vec<true>(raw, head.a, head.b, E())
                    : normalise_vec<false>(raw, head.a, head.b, E()));
        head.step(p.hw);
      }
      __syncthreads();
      if (tid == 0) {
        fence_async_smem();
        copy_in(u + p.slots, c);
      }
    }
    // the statistics are free for the next round
    __syncthreads();
    GN_STAMP(4);
  }
#ifdef GN_PHASE_STAMPS
  if (tid == 0) {
    gn_phase_cycles[blockIdx.x][GN_PHASES] += clock64() - stamp_start;
    gn_phase_cycles[blockIdx.x][GN_PHASES + 1] += (p.units - slot + p.slots - 1) / p.slots;
  }
#endif
}

// The units a round of a grid: every unit of a round kept whole in the
// card's `sms` blocks of `kept` bytes where they fit; else as many as keep
// their tails (what the blocks cannot keep) within L2_TAIL_BYTES, at least
// one.  Then balanced over the rounds.
int grid_slots(long long unit_bytes, int units, int sms, long long kept) {
  int k;
  if ((long long)units * unit_bytes <= (long long)sms * kept) {
    k = units < sms ? units : sms;
  } else {
    k = 1;
    for (int cand = 2; cand <= units && cand <= sms; ++cand) {
      const long long tail = unit_bytes - (long long)(sms / cand) * kept;
      if (tail > 0 && (long long)cand * tail > L2_TAIL_BYTES) break;
      k = cand;
    }
  }
  const int rounds = (units + k - 1) / k;
  return (units + rounds - 1) / rounds;
}

// The plan of a grid launch: units of `unit` elements, `units` of them, on
// `sms` blocks of at most `keep_max` elements of shared memory each;
// slices and kept parts of whole `granule`s, chunks of whole
// `chunk_granule`s (a block step, so a warp's stores do not straddle more
// 128-byte lines than they must).
bool plan_grid(GridPlan& p, long long unit, int units, int sms, long long keep_max,
               int granule, int chunk_granule, int elem) {
  const long long unit_bytes = unit * elem;
  const long long kept = keep_max / chunk_granule * chunk_granule;
  const int k = grid_slots(unit_bytes, units, sms, kept * elem);
  int blocks = sms / k;
  // small units: no slice below GRID_MIN_SLICE_BYTES
  const long long spread = unit_bytes / GRID_MIN_SLICE_BYTES;
  if (spread < blocks) blocks = spread > 1 ? (int)spread : 1;
  const long long slice = ((unit + blocks - 1) / blocks + granule - 1) / granule * granule;
  const long long keep = slice < kept ? slice : kept;
  if (slice >= (1ll << 31)) return false;
  p.unit = unit;
  p.units = units;
  p.slots = k;
  p.blocks = blocks;
  p.slice = (int)slice;
  p.keep = (int)keep;
  p.granule = chunk_granule;
  return true;
}

template <typename E>
cudaError_t launch_grid(const E* x, const float* w, const float* b, E* out, int B, int C,
                        int HW, int G, float eps, bool silu, cudaStream_t st) {
  static bool ready = false;  // one card a process: the attribute is set once
  auto kernel = gn_grid_kernel<E, GRID_THREADS>;
  constexpr int W = Elem<E>::VEC;
  constexpr int red_bytes = 16;  // the statistics
  // slices starting on GRID_ALIGN bytes; chunks of whole block steps
  const int granule = GRID_ALIGN / (int)sizeof(E);
  const int chunk_granule = GRID_THREADS * W;
  const long long keep_max = (long long)((GRID_SMEM - red_bytes) / (int)sizeof(E));
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (!ready) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GRID_SMEM);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  GridPlan p;
  const int cpg = C / G;
  if (!plan_grid(p, (long long)cpg * HW, B * G, sms, keep_max, granule, chunk_granule,
                 (int)sizeof(E)))
    return cudaErrorInvalidValue;
  p.hw = HW;
  p.cpg = cpg;
  p.groups = G;
  p.eps = eps;
  const size_t smem = ((size_t)p.keep * sizeof(E) + 15) / 16 * 16 + red_bytes;
  // the launch's own scratch, in stream order: the meeting counters (zeroed)
  // and then the sums
  const size_t count_bytes = (2 * (size_t)p.slots * sizeof(unsigned int) + 15) / 16 * 16;
  const size_t sum_bytes = 2 * (size_t)p.slots * p.blocks * sizeof(float2);
  void* scratch = nullptr;
  err = cudaMallocAsync(&scratch, count_bytes + sum_bytes, st);
  if (err != cudaSuccess) return err;
  p.arrived = static_cast<unsigned int*>(scratch);
  p.passed = p.arrived + p.slots;
  p.sums = reinterpret_cast<float2*>(static_cast<unsigned char*>(scratch) + count_bytes);
  err = cudaMemsetAsync(scratch, 0, count_bytes, st);
  // at most one block an SM (plan_grid): a cooperative launch the card
  // cannot hold at once is refused, never run
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3((unsigned)(p.slots * p.blocks));
  cfg.blockDim = dim3(GRID_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, x, w, b, out, p, silu);
  const cudaError_t freed = cudaFreeAsync(scratch, st);
  return err != cudaSuccess ? err : freed;
}

// ---------------------------------------------------------------------------
// Channels-minor (NHWC) x: slabs of whole groups.
//
// There a group is cpg channels of every pixel, no contiguous run of memory.
// A slab of gs whole groups is a column of sc = gs * cpg channels out of
// every pixel's C, and its statistics need that column and nothing else: the
// unit a set of blocks shares is (image, slab), HW * sc elements, and it is
// small enough to be kept on chip where a whole image is not.  How wide a
// column is decides how fast the bus moves it (gn_phases.py --columns, an
// H100: columns of 32 bytes out of 256-byte rows read at a third of whole
// rows' rate, 64 bytes at three quarters, 128 bytes at 93%), so a slab is
// the fewest whole groups whose column holds SLAB_MIN_COLUMN bytes and is a
// multiple of 32 (one sector), else of 16, or the whole pixel where the row
// is narrower.
//
// A unit's P blocks take a run of its pixels each, the whole column of each
// pixel; K units a round, the K * P blocks, one an SM, walk the units in
// rounds.  A block's slice lands in its shared memory densely, [pixel][sc],
// by 16-byte cp.async from each thread into the slots that the same thread
// reads afterwards: a thread owns one 16-byte column of W channels of the
// slab and every S-th pixel of the slice, so it waits only on its own copies
// (chunk by chunk, cp.async groups), and issues the next round's copies of a
// chunk as soon as it has stored that chunk.  A round, per block:
//   1. the sums: per thread per channel of its column, per channel over a
//      warp's pixels (a fixed tree of shuffles), per channel over the warps in
//      order, then per group over its channels (a warp a group, lanes over
//      its channels in order, then a fixed tree);
//   2. the unit's blocks meet.  Where at most 16 blocks keep a unit (the
//      UNet's images, the VAE's at 96x96) and that takes no more rounds than
//      a grid would, they are one thread block CLUSTER and read each other's
//      group sums through distributed shared memory after one cluster
//      barrier (the sums double-buffered by round, so one barrier a round is
//      enough; no device memory, no counter).  Otherwise (the VAE's from
//      192x192 up) a cooperative grid, whose blocks write their sums to fixed
//      places of the launch's scratch (from the stream's pool) and meet at an
//      integer counter that only grows;
//   3. every block adds the unit's P sums over the blocks in rank order (the
//      grid's sums group-major, a group's P in a row: read a few lines a
//      warp, where block-major every warp of every block would read every
//      block's line), so all have the same totals and the output is the same
//      on every run, then normalises its slice and stores it, streaming.
// A grid round takes as many units as the card keeps whole, or more while
// what the blocks cannot keep (the tails, read from device memory with an L2
// evict-last policy and read again after the meeting) stays within
// L2_TAIL_BYTES.  A unit beyond the card's shared memory (the 768x768 VAE's,
// 75 MB in bf16) takes every block; the last SLAB_L2_KEEP_BYTES of the
// round's tails are read evict-last and read again first, the rest evict-
// first: that part is read twice from device memory.  The second reads are
// issued SLAB_TAIL_LOADS at a time, as the first are.
//
// C * sizeof(E) % 16 != 0 (rare: x's rows not 16-byte vectors) takes an
// element-wise instance: a thread a channel, plain loads.

constexpr int SLAB_THREADS = 512;
constexpr int SLAB_WARPS = SLAB_THREADS / 32;
// cp.async groups a round's kept part lands in (cp_async_wait_n takes 0 to 3)
constexpr int SLAB_CHUNKS = 4;
// the narrowest column a slab takes where the row is wider (gn_phases.py
// --columns: 128-byte columns move at 93% of whole rows' rate, 64-byte ones
// at 62-74%)
constexpr int SLAB_MIN_COLUMN = 128;
// loads of a tail in flight a thread
constexpr int SLAB_TAIL_LOADS = 4;
// a grid round's tails read with an L2 evict-last policy, at most (the rest
// of a tail is read evict-first: it comes from device memory again)
constexpr long long SLAB_L2_KEEP_BYTES = 32ll << 20;
// a unit is not cut into slices smaller than this to spread it over the card
constexpr int SLAB_MIN_SLICE_BYTES = 16384;

struct SlabPlan {
  int hw, c, cpg;
  int sc;      // channels a slab: gs whole groups
  int gs;      // groups a slab
  int slabs;   // slabs an image
  int units;   // B * slabs
  int slots;   // units a round, K
  int blocks;  // blocks a unit, P (the cluster's size where it is one)
  int pix;     // pixels of a block's slice
  int keep;    // of which the first `keep` stay in shared memory (all, or whole steps)
  int hot;     // steps at the end of a tail read with an L2 evict-last policy
  float eps;
  // the grid's scratch: the blocks' group sums, float2 per (parity, slot,
  // group, block), and each slot's arrival counter (zeroed)
  float2* sums;
  unsigned int* arrived;
};

// Where a thread of a slab block sits.  cols 16-byte columns (elements:
// channels) a pixel; up to 32 of them, a warp takes pw = 32 / cols whole
// pixels at once, lanes past pw * cols idle; wider, a pixel takes
// ceil(cols / 32) warps.  A block step is S pixels; the table of the
// block's per-channel sums has `rows` rows: a warp's, or a pixel's.
struct SlabThread {
  int cols, pw, px, col, pslot, S, rows, row;
  bool active;
  __host__ __device__ SlabThread(int cols_, int tid) : cols(cols_) {
    const int warp = tid >> 5, lane = tid & 31;
    if (cols <= 32) {
      pw = 32 / cols;
      px = lane / cols;
      col = lane - px * cols;
      active = px < pw;
      pslot = warp * pw + px;
      S = SLAB_WARPS * pw;
      rows = SLAB_WARPS;
      row = warp;
    } else {
      const int wpp = (cols + 31) / 32;
      pw = 1;
      px = 0;
      pslot = warp / wpp;
      col = (warp - pslot * wpp) * 32 + lane;
      S = SLAB_WARPS / wpp;
      active = col < cols && pslot < S;
      rows = S;
      row = pslot;
    }
  }
};

// Shared memory of a slab block: the kept pixels' columns, the per-channel
// table, the group sums by round parity and the statistics.
__host__ __device__ inline size_t slab_kept_bytes(const SlabPlan& p, int elem) {
  return ((size_t)p.keep * p.sc * elem + 15) / 16 * 16;
}
__host__ __device__ inline size_t slab_smem(const SlabPlan& p, int elem, int rows) {
  return slab_kept_bytes(p, elem) + ((size_t)rows * p.sc + 3 * (size_t)p.gs) * sizeof(float2);
}

// until at most n (0 to 3) of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}
static_assert(SLAB_CHUNKS == 4, "cp_async_wait_n takes 0 to 3");

// The blocks of a grid unit meet (one thread of each): each arrives once on
// its slot's counter, a release, and waits until the count reaches `target`
// (the unit's blocks times the rounds so far).  Co-resident blocks (a
// cooperative launch): no block waits on one that cannot run.
__device__ __forceinline__ void meet_count(unsigned int* counter, unsigned int target) {
  __threadfence();
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
  while (load_acquire(counter) < target) __nanosleep(32);
  __threadfence();
}

// W floats of 16 bytes of x, or one element
template <typename E, int W>
__device__ __forceinline__ void load_vec(const E* p, float (&f)[W]) {
  if constexpr (W == 1)
    f[0] = Elem<E>::to_float(*p);
  else
    unpack(*reinterpret_cast<const uint4*>(p), f, E());
}

// Grid: K * P blocks of SLAB_THREADS, block slot * P + rank; CLUSTER: the P
// blocks of a slot are a cluster.
template <typename E, bool VEC, bool CLUSTER>
__global__ void __launch_bounds__(SLAB_THREADS, 1)
gn_slab_kernel(const E* __restrict__ x, const float* __restrict__ weight,
               const float* __restrict__ bias, E* __restrict__ out, SlabPlan p, bool silu) {
  constexpr int W = VEC ? Elem<E>::VEC : 1;  // channels a thread's column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const SlabThread t(p.sc / W, tid);
  E* kept = reinterpret_cast<E*>(smem_raw);
  float2* red = reinterpret_cast<float2*>(smem_raw + slab_kept_bytes(p, sizeof(E)));
  float2* part = red + (size_t)t.rows * p.sc;  // this block's group sums, by round parity
  float2* stats = part + 2 * p.gs;             // (mean, 1 / std) a group
  const int slot = blockIdx.x / p.blocks;
  const int rank = blockIdx.x - slot * p.blocks;
  const float n = (float)p.cpg * (float)p.hw;
#ifdef GN_PHASE_STAMPS
  const long long stamp_start = clock64();
  long long stamp_mark = stamp_start;
#endif

  // this block's slice of a unit: pixels [lo, lo + len), the first kept_n kept
  const int lo = (long long)rank * p.pix < p.hw ? rank * p.pix : p.hw;
  const int len = (lo + p.pix < p.hw ? lo + p.pix : p.hw) - lo;
  const int kept_n = len < p.keep ? len : p.keep;
  // the thread's pixels are pslot + j * S: j < jk may be kept (kept_n is
  // the whole slice or whole steps), jc of them a chunk
  const int jk = (kept_n + t.S - 1) / t.S;
  const int jc = (jk + SLAB_CHUNKS - 1) / SLAB_CHUNKS;
  // the tail's steps from jh on are read with an L2 evict-last policy
  const int jh = max(jk, (len + t.S - 1) / t.S - p.hot);
  const size_t C = p.c;
  // pixel i of unit u's slice, at the thread's column
  auto at = [&](long long u) -> size_t {
    const long long b = u / p.slabs;
    return ((size_t)b * p.hw + lo) * C + (size_t)(u - b * p.slabs) * p.sc + (size_t)t.col * W;
  };
  uint64_t first, last;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(first));
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(last));

  // the thread's kept vectors of chunk c of unit u, one cp.async group
  auto copy_in = [&](long long u, int c) {
    if (t.active && u < p.units) {
      const E* src = x + at(u);
      const int j1 = (c + 1) * jc < jk ? (c + 1) * jc : jk;
      for (int j = c * jc; j < j1; ++j) {
        const int i = t.pslot + j * t.S;
        if (i < kept_n)
          cp_async_16_hinted(kept + ((size_t)i * t.cols + t.col) * W, src + (size_t)i * C, first);
      }
    }
    cp_async_commit();
  };
  if constexpr (VEC)
    for (int c = 0; c < SLAB_CHUNKS; ++c) copy_in(slot, c);

  for (int round = 0;; ++round) {
    const long long u = (long long)round * p.slots + slot;
    if (u >= p.units) break;
    const int par = round & 1;
    const int s0 = (int)(u % p.slabs) * p.sc;  // the slab's first channel
    const E* xs = x + at(u);
    E* os = out + at(u);

    // 1. the sums of the thread's W channels: the tail from device memory,
    // then the kept part as its chunks land
    float s[W], ss[W];
#pragma unroll
    for (int k = 0; k < W; ++k) s[k] = ss[k] = 0.0f;
    auto add = [&](const float (&f)[W]) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        s[k] += f[k];
        ss[k] += f[k] * f[k];
      }
    };
    if (t.active) {
      if constexpr (VEC) {
        // the tail's steps [jk, jh) evict-first, [jh, ...) evict-last
        for (int part = 0; part < 2; ++part) {
          const int i0 = t.pslot + (part ? jh : jk) * t.S;
          const int i1 = part ? len : min(len, t.pslot + jh * t.S);
          const uint64_t policy = part ? last : first;
          for (int i = i0; i < i1; i += SLAB_TAIL_LOADS * t.S) {
            uint4 raw[SLAB_TAIL_LOADS];
#pragma unroll
            for (int k = 0; k < SLAB_TAIL_LOADS; ++k)
              if (i + k * t.S < i1) raw[k] = load_evict_last(xs + (size_t)(i + k * t.S) * C, policy);
#pragma unroll
            for (int k = 0; k < SLAB_TAIL_LOADS; ++k)
              if (i + k * t.S < i1) {
                float f[W];
                unpack(raw[k], f, E());
                add(f);
              }
          }
        }
      } else {
        for (int i = t.pslot; i < len; i += t.S) {
          const E v = xs[(size_t)i * C];
          if (i < kept_n) kept[(size_t)i * t.cols + t.col] = v;
          const float f[1] = {Elem<E>::to_float(v)};
          add(f);
        }
      }
    }
    if constexpr (VEC) {
      for (int c = 0; c < SLAB_CHUNKS; ++c) {
        cp_async_wait_n(SLAB_CHUNKS - 1 - c);
        const int j1 = (c + 1) * jc < jk ? (c + 1) * jc : jk;
        for (int j = c * jc; t.active && j < j1; ++j) {
          const int i = t.pslot + j * t.S;
          if (i < kept_n) {
            float f[W];
            load_vec<E, W>(kept + ((size_t)i * t.cols + t.col) * W, f);
            add(f);
          }
        }
      }
    }
    GN_STAMP_BYTES((long long)(2 * len - kept_n) * p.sc * (long long)sizeof(E));
    GN_STAMP(0);

    // 2. per channel over the warp's pixels: a fixed tree, lanes of pixel 0
    // holding the warp's sums
    for (int o = 1; o < t.pw; o <<= 1) {
      const bool take = (t.px & (2 * o - 1)) == 0 && t.px + o < t.pw;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float a = __shfl_down_sync(0xffffffffu, s[k], o * t.cols);
        const float b = __shfl_down_sync(0xffffffffu, ss[k], o * t.cols);
        if (take) {
          s[k] += a;
          ss[k] += b;
        }
      }
    }
    if (t.active && t.px == 0)
#pragma unroll
      for (int k = 0; k < W; ++k)
        red[(size_t)t.row * p.sc + t.col * W + k] = make_float2(s[k], ss[k]);
    __syncthreads();
    // per channel over the table's rows in order (only this thread reads
    // column ch), then per group over its channels: warp w groups w, w +
    // SLAB_WARPS, ..., lane l channels l, l + 32, ... in order, then one
    // fixed tree
    for (int ch = tid; ch < p.sc; ch += SLAB_THREADS) {
      float2 v = red[ch];
#pragma unroll 4
      for (int r = 1; r < t.rows; ++r) {
        const float2 w = red[(size_t)r * p.sc + ch];
        v.x += w.x;
        v.y += w.y;
      }
      red[ch] = v;
    }
    __syncthreads();
    // the grid's sums, group-major
    float2* const unit_sums = p.sums + ((size_t)par * p.slots + slot) * p.gs * p.blocks;
    for (int g = warp; g < p.gs; g += SLAB_WARPS) {
      float2 v = make_float2(0.0f, 0.0f);
      for (int ch = g * p.cpg + lane; ch < (g + 1) * p.cpg; ch += 32) {
        v.x += red[ch].x;
        v.y += red[ch].y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
        v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
      }
      if (lane == 0) {
        if constexpr (CLUSTER)
          part[par * p.gs + g] = v;
        else
          unit_sums[(size_t)g * p.blocks + rank] = v;
      }
    }
    GN_STAMP(1);

    // the unit's blocks meet: a cluster barrier, or the grid's counter
    if constexpr (CLUSTER) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
      if (tid == 0)
        meet_count(p.arrived + slot, (unsigned int)p.blocks * (unsigned int)(round + 1));
      __syncthreads();
    }
    GN_STAMP(2);

    // 3. warp w adds groups w, w + SLAB_WARPS, ... over the unit's blocks,
    // lane j block j, j + 32, ..., then one fixed tree
    for (int g = warp; g < p.gs; g += SLAB_WARPS) {
      float2 v = make_float2(0.0f, 0.0f);
      for (int j0 = lane; j0 < p.blocks; j0 += 4 * 32) {
        // four loads in flight, added in block order
        float2 w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 32 * q;
          w[q] = make_float2(0.0f, 0.0f);
          if (j < p.blocks) {
            if constexpr (CLUSTER)
              w[q] = *cg::this_cluster().map_shared_rank(part + par * p.gs + g, j);
            else
              w[q] = __ldcg(unit_sums + (size_t)g * p.blocks + j);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v.x += w[q].x;
          v.y += w[q].y;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
        v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
      }
      if (lane == 0) {
        const float mean = v.x / n;
        const float var = fmaxf(v.y / n - mean * mean, 0.0f);
        stats[g] = make_float2(mean, rsqrtf(var + p.eps));
      }
    }
    __syncthreads();
    GN_STAMP(3);

    // 4. normalise: the tail (read again, from L2 where it stayed), then the
    // kept part chunk by chunk, each chunk taking the next round's copies
    // once the thread has stored it
    float a[W], b[W];
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const int ch = t.active ? t.col * W + k : 0;
      const float2 st = stats[ch / p.cpg];
      a[k] = st.y * weight[s0 + ch];
      b[k] = bias[s0 + ch] - st.x * a[k];
    }
    auto store = [&](size_t off, float (&f)[W]) {
#pragma unroll
      for (int k = 0; k < W; ++k) f[k] = act(silu, f[k] * a[k] + b[k]);
      if constexpr (W == 1)
        os[off] = Elem<E>::from_float(f[0]);
      else
        __stcs(reinterpret_cast<uint4*>(os + off), pack(f, E()));
    };
    auto store_tail = [&]() {
      if (!t.active) return;
      if constexpr (VEC) {
        // what L2 kept first, then the rest
        for (int part = 0; part < 2; ++part) {
          const int i0 = t.pslot + (part ? jk : jh) * t.S;
          const int i1 = part ? min(len, t.pslot + jh * t.S) : len;
          for (int i = i0; i < i1; i += SLAB_TAIL_LOADS * t.S) {
            uint4 raw[SLAB_TAIL_LOADS];
#pragma unroll
            for (int k = 0; k < SLAB_TAIL_LOADS; ++k)
              if (i + k * t.S < i1) raw[k] = __ldcs(reinterpret_cast<const uint4*>(xs + (size_t)(i + k * t.S) * C));
#pragma unroll
            for (int k = 0; k < SLAB_TAIL_LOADS; ++k)
              if (i + k * t.S < i1) {
                float f[W];
                unpack(raw[k], f, E());
                store((size_t)(i + k * t.S) * C, f);
              }
          }
        }
      } else {
        for (int i = t.pslot; i < len; i += t.S) {
          float f[1] = {Elem<E>::to_float(i < kept_n ? kept[(size_t)i * t.cols + t.col]
                                                     : xs[(size_t)i * C])};
          store((size_t)i * C, f);
        }
      }
    };
    store_tail();
    if constexpr (VEC) {
      for (int c = 0; c < SLAB_CHUNKS; ++c) {
        const int j1 = (c + 1) * jc < jk ? (c + 1) * jc : jk;
#pragma unroll 2
        for (int j = c * jc; t.active && j < j1; ++j) {
          const int i = t.pslot + j * t.S;
          if (i < kept_n) {
            float f[W];
            load_vec<E, W>(kept + ((size_t)i * t.cols + t.col) * W, f);
            store((size_t)i * C, f);
          }
        }
        copy_in(u + p.slots, c);
      }
    }
    // the table and the statistics are free for the next round
    __syncthreads();
    GN_STAMP(4);
  }
  // no block of a cluster leaves while its sums may still be read
  if constexpr (CLUSTER) {
    cluster_arrive();
    cluster_wait();
  }
#ifdef GN_PHASE_STAMPS
  if (tid == 0) {
    gn_phase_cycles[blockIdx.x][GN_PHASES] += clock64() - stamp_start;
    gn_phase_cycles[blockIdx.x][GN_PHASES + 1] += (p.units - slot + p.slots - 1) / p.slots;
  }
#endif
}

// The groups a slab: the fewest whole groups (a divisor of G) whose column
// holds SLAB_MIN_COLUMN bytes or the whole pixel and is a multiple of 32
// bytes, else of 16; elements: the fewest whose column holds SLAB_MIN_COLUMN
// bytes, or all.  A column's threads fit a block (at most SLAB_THREADS
// columns of W channels); 0 where no slab does: a group wider than that.
int pick_slab(int G, int cpg, int elem, int W, int min_column) {
  int first16 = 0, widest = 0;
  for (int gs = 1; gs <= G; ++gs) {
    if (G % gs) continue;
    const long long bytes = (long long)gs * cpg * elem;
    if ((long long)gs * cpg / W > SLAB_THREADS) break;
    const bool wide = bytes >= min_column || gs == G;
    if (W == 1) {
      if (wide) return gs;
      widest = gs;
      continue;
    }
    if (bytes % 16) continue;
    if (wide && bytes % 32 == 0) return gs;
    if (wide && !first16) first16 = gs;
    widest = gs;
  }
  return first16 ? first16 : widest;
}

// The largest number of clusters of `P` full-shared-memory slab blocks the
// card holds at once, for P = 1 ... MAX_CLUSTER (0: none), asked once.
struct SlabDevice {
  int sms = 0;
  int clusters[MAX_CLUSTER + 1] = {};
  bool ready = false;
};

// The plan of a slab launch; false where the shape cannot be planned.
bool plan_slabs(SlabPlan& p, bool& cluster, const SlabDevice& dev, int B, int C, int HW, int G,
                int elem, int W) {
  const int cpg = C / G;
  const int sms = dev.sms;
  const int gs = pick_slab(G, cpg, elem, W, SLAB_MIN_COLUMN);
  if (gs == 0 || (long long)B * G >= (1ll << 31)) return false;
  p.hw = HW;
  p.c = C;
  p.cpg = cpg;
  p.gs = gs;
  p.sc = gs * cpg;
  p.slabs = G / gs;
  p.units = B * p.slabs;
  // the pixels a block keeps, whole steps
  const SlabThread t(p.sc / W, 0);
  const long long col_bytes = (long long)p.sc * elem;
  const long long fixed = ((long long)t.rows * p.sc + 3ll * gs) * (long long)sizeof(float2) + 16;
  const long long keep_max = (GRID_SMEM - fixed) / col_bytes / t.S * t.S;
  if (keep_max < 1) return false;
  auto spread_ok = [&](int P) { return (HW + P - 1) / P * col_bytes >= SLAB_MIN_SLICE_BYTES; };
  // clusters (one block an SM), where a cluster keeps a unit: as many units a
  // round as the card places at once, balanced over the rounds, then each
  // unit on more blocks while that many clusters still fit, the card has the
  // SMs and the slices stay above the floor
  const long long pmin = (HW + keep_max - 1) / keep_max;
  int cP = 0, cK = 0, c_rounds = 0;
  if (pmin <= MAX_CLUSTER && dev.clusters[pmin] > 0) {
    cP = (int)pmin;
    cK = p.units < dev.clusters[cP] ? p.units : dev.clusters[cP];
    c_rounds = (p.units + cK - 1) / cK;
    cK = (p.units + c_rounds - 1) / c_rounds;
    while (cP < MAX_CLUSTER && dev.clusters[cP + 1] >= cK && (long long)cK * (cP + 1) <= sms &&
           spread_ok(cP + 1))
      ++cP;
  }
  // the grid: as many units a round as the card keeps whole, or with their
  // tails within L2_TAIL_BYTES.  Clusters where they need no more rounds.
  const int K = grid_slots((long long)HW * col_bytes, p.units, sms, keep_max * col_bytes);
  int P = sms / K;
  while (P > 1 && !spread_ok(P)) --P;
  if (cP && c_rounds <= (p.units + K - 1) / K) {
    cluster = true;
    p.slots = cK;
    p.blocks = cP;
    p.pix = (HW + cP - 1) / cP;
    p.keep = p.pix;
    p.hot = 0;
    return true;
  }
  cluster = false;
  p.slots = K;
  p.blocks = P;
  p.pix = (HW + P - 1) / P;
  p.keep = p.pix < keep_max ? p.pix : (int)keep_max;
  // each block's share of the round's L2 budget, in steps
  p.hot = (int)(SLAB_L2_KEEP_BYTES / ((long long)K * P) / (t.S * col_bytes));
  return true;
}

// The card as the slab kernel of (E, VEC) sees it, asked once (one card a
// process): its SMs, its clusters, the kernels' attributes set.
template <typename E, bool VEC>
cudaError_t slab_device(const SlabDevice** out) {
  static SlabDevice dev;
  *out = &dev;
  if (dev.ready) return cudaSuccess;
  auto cluster_kernel = gn_slab_kernel<E, VEC, true>;
  auto grid_kernel = gn_slab_kernel<E, VEC, false>;
  cudaError_t err = sm_count(&dev.sms);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GRID_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GRID_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.blockDim = dim3(SLAB_THREADS);
  cfg.dynamicSmemBytes = GRID_SMEM;
  for (int P = 1; P <= MAX_CLUSTER; ++P) {
    attr[0].val.clusterDim.x = P;
    cfg.gridDim = dim3(P);
    if (cudaOccupancyMaxActiveClusters(&dev.clusters[P], cluster_kernel, &cfg) != cudaSuccess) {
      dev.clusters[P] = 0;
      (void)cudaGetLastError();
    }
  }
  dev.ready = true;
  return cudaSuccess;
}

template <typename E, bool VEC>
cudaError_t launch_slabs(const E* x, const float* w, const float* b, E* out, int B, int C,
                         int HW, int G, float eps, bool silu, cudaStream_t st) {
  constexpr int W = VEC ? Elem<E>::VEC : 1;
  const SlabDevice* dev = nullptr;
  cudaError_t err = slab_device<E, VEC>(&dev);
  if (err != cudaSuccess) return err;
  SlabPlan p = {};
  bool cluster = false;
  if (!plan_slabs(p, cluster, *dev, B, C, HW, G, (int)sizeof(E), W)) return cudaErrorInvalidValue;
  p.eps = eps;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.blockDim = dim3(SLAB_THREADS);
  cfg.stream = st;
  cfg.gridDim = dim3((unsigned)(p.slots * p.blocks));
  cfg.dynamicSmemBytes = slab_smem(p, (int)sizeof(E), SlabThread(p.sc / W, 0).rows);
  if (cluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    return cudaLaunchKernelEx(&cfg, gn_slab_kernel<E, VEC, true>, x, w, b, out, p, silu);
  }
  // the launch's own scratch, in stream order: the counters (zeroed), then
  // the sums; at most one block an SM, so a cooperative launch the card
  // cannot hold at once is refused, never run
  const size_t count_bytes = ((size_t)p.slots * sizeof(unsigned int) + 15) / 16 * 16;
  const size_t sum_bytes = 2 * (size_t)p.slots * p.blocks * p.gs * sizeof(float2);
  void* scratch = nullptr;
  err = cudaMallocAsync(&scratch, count_bytes + sum_bytes, st);
  if (err != cudaSuccess) return err;
  p.arrived = static_cast<unsigned int*>(scratch);
  p.sums = reinterpret_cast<float2*>(static_cast<unsigned char*>(scratch) + count_bytes);
  err = cudaMemsetAsync(scratch, 0, count_bytes, st);
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, gn_slab_kernel<E, VEC, false>, x, w, b, out, p, silu);
  const cudaError_t freed = cudaFreeAsync(scratch, st);
  return err != cudaSuccess ? err : freed;
}

// NHWC x: 16-byte vectors where C * sizeof(E) % 16 == 0, elements otherwise.
template <typename E>
int group_norm_nhwc(const void* x, const void* weight, const void* bias, void* out, int B,
                    int C, int HW, int G, float eps, int act, void* stream) {
  if (B < 1 || C < 1 || HW < 1 || G < 1 || C % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const E* xin = static_cast<const E*>(x);
  E* y = static_cast<E*>(out);
  const float* w = static_cast<const float*>(weight);
  const float* bb = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool silu = act == 1;
  const cudaError_t err =
      C % Elem<E>::VEC ? launch_slabs<E, false>(xin, w, bb, y, B, C, HW, G, eps, silu, st)
                       : launch_slabs<E, true>(xin, w, bb, y, B, C, HW, G, eps, silu, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  cudaError_t err;
  if constexpr (sizeof(E) == 4) {
    // float32 groups a cluster cannot keep: the persistent grid keeps them
    if (HW % Elem<E>::VEC == 0 && bytes > (long long)MAX_CLUSTER * LARGE.keep) {
      err = launch_grid<E>(xin, w, bb, y, B, C, HW, G, eps, silu, st);
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(cudaGetLastError());
    }
  }
  int sms = 0;
  err = sm_count(&sms);
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

// The same on float32 x and out (groups above 16 x 220 KB on the persistent
// grid, its sums and counters scratch from the stream's pool).
extern "C" int gswm_group_norm_f32(const void* x, const void* weight, const void* bias,
                                   void* out, int B, int C, int HW, int G, float eps, int act,
                                   void* stream) {
  return group_norm<float>(x, weight, bias, out, B, C, HW, G, eps, act, stream);
}

// x, out: channels-minor, (B, HW, C) in memory (NHWC, torch.channels_last),
// bf16, 16-byte aligned; the rest as gswm_group_norm.  One launch of the slab
// kernel: clusters, or a cooperative grid whose sums and counters are scratch
// from the stream's pool.  Any C divisible by G whose group is at most 4096
// channels (16-byte vectors, C * 2 % 16 == 0) or 512 (elements).
extern "C" int gswm_group_norm_nhwc(const void* x, const void* weight, const void* bias,
                                    void* out, int B, int C, int HW, int G, float eps, int act,
                                    void* stream) {
  return group_norm_nhwc<bf16>(x, weight, bias, out, B, C, HW, G, eps, act, stream);
}

// The same on float32 x and out (a group at most 2048 channels, or 512 where
// C * 4 % 16 != 0).
extern "C" int gswm_group_norm_nhwc_f32(const void* x, const void* weight, const void* bias,
                                        void* out, int B, int C, int HW, int G, float eps,
                                        int act, void* stream) {
  return group_norm_nhwc<float>(x, weight, bias, out, B, C, HW, G, eps, act, stream);
}

#ifdef GN_PHASE_STAMPS
// The measurement build's stamps: copied to `host` (GN_STAMP_BLOCKS rows of
// GN_PHASES + 3 long longs: the phases' cycles, the block's total, its
// rounds, the bytes of x it loaded), then zeroed.
extern "C" int gswm_group_norm_phases(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, gn_phase_cycles, sizeof(gn_phase_cycles));
  void* stamps = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&stamps, gn_phase_cycles);
  if (e == cudaSuccess) e = cudaMemset(stamps, 0, sizeof(gn_phase_cycles));
  return static_cast<int>(e);
}

// The slab kernel's plan for (B, C, HW, G) of float32 (f32) or bf16 x into
// `out`: cluster (1) or grid (0), groups a slab, units, K, P, pixels a
// slice, kept pixels, evict-last steps, then the card's clusters of 1 to 16
// blocks of the whole shared memory.
extern "C" int gswm_slab_plan(int B, int C, int HW, int G, int f32, int* out) {
  const SlabDevice* dev = nullptr;
  const int elem = f32 ? 4 : 2;
  const bool vec = C * elem % 16 == 0;
  const int W = vec ? 16 / elem : 1;
  cudaError_t e = f32 ? (vec ? slab_device<float, true>(&dev) : slab_device<float, false>(&dev))
                      : (vec ? slab_device<bf16, true>(&dev) : slab_device<bf16, false>(&dev));
  if (e != cudaSuccess) return static_cast<int>(e);
  SlabPlan p = {};
  bool cluster = false;
  if (!plan_slabs(p, cluster, *dev, B, C, HW, G, elem, W)) return 1;
  const int fields[] = {cluster, p.gs, p.units, p.slots, p.blocks, p.pix, p.keep, p.hot};
  for (int k = 0; k < 8; ++k) out[k] = fields[k];
  for (int P = 1; P <= MAX_CLUSTER; ++P) out[7 + P] = dev->clusters[P];
  return 0;
}

// The column probe: how fast a column of `col16` 16-byte vectors at vector
// `off16` of each of `rows` rows of `row16` vectors moves (col16 a power of
// two), copied to the same place of `out` (mode 0) or read alone (mode 1),
// 16 bytes a thread, four loads in flight, streaming (evict-first) loads and
// stores: what a slab of whole groups costs against whole rows.
__global__ void column_probe_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                                    long long rows, int row16, int col_shift, int off16,
                                    int mode) {
  const long long n = rows << col_shift;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int mask = (1 << col_shift) - 1;
  unsigned int acc = 0;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n; v += 4 * stride) {
    uint4 r[4];
    long long at[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long q = v + k * stride;
      at[k] = (q >> col_shift) * row16 + off16 + (int)(q & mask);
      if (q < n) r[k] = __ldcs(x + at[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (v + k * stride >= n) break;
      if (mode == 0)
        __stcs(out + at[k], r[k]);
      else
        acc ^= r[k].x ^ r[k].y ^ r[k].z ^ r[k].w;
    }
  }
  if (mode == 1 && acc == 0x9e3779b9u) out[0] = make_uint4(acc, 0, 0, 0);  // keeps the loads
}

extern "C" int gswm_column_probe(const void* x, void* out, long long rows, int row_bytes,
                                 int col_bytes, int off_bytes, int mode, void* stream) {
  int shift = 0;
  while ((16 << shift) < col_bytes) ++shift;
  if ((16 << shift) != col_bytes || row_bytes % 16 || off_bytes % 16) return 1;
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint4* src = static_cast<const uint4*>(x);
  uint4* dst = static_cast<uint4*>(out);
  int row16 = row_bytes / 16, off16 = off_bytes / 16;
  void* args[] = {&src, &dst, &rows, &row16, &shift, &off16, &mode};
  return static_cast<int>(cudaLaunchKernel((const void*)column_probe_kernel, dim3(sms * 4),
                                           dim3(512), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}
#endif

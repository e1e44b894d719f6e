// GroupNorm (+ optional SiLU) on NCHW bf16, fp32 statistics.
//
// Replaces gswm/ops/groupnorm.py:185 fused_group_norm (_resident_kernel
// :112, _stats_kernel :138, _apply_kernel :150; pallas_calls :210, :229,
// :243), the JAX package's GroupNorm op over NHWC.  Its numerics:
// per (image, group) fp32 sums s and ss, mean = s / n, var = max(ss / n -
// mean^2, 0), per channel a = rsqrt(var + eps) * weight and b = bias -
// mean * a, y = x * a + b, optionally y * sigmoid(y), rounded to x's dtype
// (groupnorm.py:80-109).
//
// What bounds it on an H100: two reads of x and one write, a few FLOP an
// element, so device-memory bandwidth.  The largest shape of the 768x768
// path is the VAE decoder's (1, 128, 768, 768): 75.5 M elements, 151 MB of
// bf16, groups of 4 * 768 * 768 = 2.36 M elements.
//
// Design.  In NCHW a group is one contiguous run of n = (C / G) * H * W
// elements.  A group that size is too much for one block (32 groups would
// fill a quarter of the 132 SMs), so both passes cut each group into chunks
// of `chunk` elements, one block each, grid (chunks, B * G):
//   * stats: each block sums its chunk (8 bf16 per 16-byte load, fp32
//     per-thread sums, warp shuffles, then across warps) and writes one
//     (s, ss) pair to `partials`; no atomics, so the result is the same on
//     every run;
//   * apply: each block first adds up its group's partials (all blocks of a
//     group in the same order, so they agree), then normalises its chunk.
// When H * W is a multiple of 8, 8 consecutive elements share a channel and
// move as one 16-byte load and store; otherwise an element-wise instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

// (a, b) summed over the block; every thread gets the result.
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ partials, long long n,
                int chunk) {
  const bf16* xg = x + (size_t)blockIdx.y * n;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(lo + chunk, n);
  float s = 0.0f, ss = 0.0f;
  if (VEC) {
    for (long long i = lo + threadIdx.x * 8; i < hi; i += THREADS * 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xg + i);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        s += f.x + f.y;
        ss += f.x * f.x + f.y * f.y;
      }
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
      const float f = __bfloat162float(xg[i]);
      s += f;
      ss += f * f;
    }
  }
  const float2 tot = block_sum2(s, ss);
  if (threadIdx.x == 0) partials[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

__device__ __forceinline__ float activate(float y, bool silu) {
  return silu ? y / (1.0f + expf(-y)) : y;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ weight,
                const float* __restrict__ bias, const float2* __restrict__ partials,
                bf16* __restrict__ out, long long n, int hw, int cpg, int groups,
                int chunk, float eps, bool silu) {
  const int bg = blockIdx.y;
  const int nchunks = gridDim.x;
  float s = 0.0f, ss = 0.0f;
  for (int i = threadIdx.x; i < nchunks; i += THREADS) {
    const float2 p = partials[(size_t)bg * nchunks + i];
    s += p.x;
    ss += p.y;
  }
  const float2 tot = block_sum2(s, ss);
  const float mean = tot.x / (float)n;
  const float var = fmaxf(tot.y / (float)n - mean * mean, 0.0f);
  const float inv = rsqrtf(var + eps);
  const int c0 = (bg % groups) * cpg;  // first channel of the group

  const size_t base = (size_t)bg * n;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = min(lo + chunk, n);
  if (VEC) {
    for (long long i = lo + threadIdx.x * 8; i < hi; i += THREADS * 8) {
      const int c = c0 + (int)(i / hw);
      const float a = inv * weight[c];
      const float b = bias[c] - mean * a;
      const uint4 raw = *reinterpret_cast<const uint4*>(x + base + i);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint4 res;
      __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(p[j]);
        r[j] = __floats2bfloat162_rn(activate(f.x * a + b, silu),
                                     activate(f.y * a + b, silu));
      }
      *reinterpret_cast<uint4*>(out + base + i) = res;
    }
  } else {
    for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
      const int c = c0 + (int)(i / hw);
      const float a = inv * weight[c];
      const float b = bias[c] - mean * a;
      out[base + i] = __float2bfloat16(activate(__bfloat162float(x[base + i]) * a + b, silu));
    }
  }
}

}  // namespace

// x, out: (B, C, HW) bf16, 16-byte aligned; weight, bias: (C,) fp32;
// partials: B * G * ceil((C / G) * HW / chunk) float2 of scratch; chunk a
// positive multiple of 8; act 0 = none, 1 = SiLU.
extern "C" int gswm_group_norm(const void* x, const void* weight, const void* bias,
                               void* out, void* partials, int B, int C, int HW, int G,
                               int chunk, float eps, int act, void* stream) {
  if (B < 1 || C < 1 || HW < 1 || G < 1 || C % G || chunk < 8 || chunk % 8 ||
      B * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpg = C / G;
  const long long n = (long long)cpg * HW;
  const dim3 grid((unsigned)((n + chunk - 1) / chunk), B * G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xin = static_cast<const bf16*>(x);
  bf16* y = static_cast<bf16*>(out);
  float2* part = static_cast<float2*>(partials);
  const float* w = static_cast<const float*>(weight);
  const float* bb = static_cast<const float*>(bias);
  if (HW % 8 == 0) {
    gn_stats_kernel<true><<<grid, THREADS, 0, st>>>(xin, part, n, chunk);
    gn_apply_kernel<true><<<grid, THREADS, 0, st>>>(xin, w, bb, part, y, n, HW, cpg, G,
                                                    chunk, eps, act == 1);
  } else {
    gn_stats_kernel<false><<<grid, THREADS, 0, st>>>(xin, part, n, chunk);
    gn_apply_kernel<false><<<grid, THREADS, 0, st>>>(xin, w, bb, part, y, n, HW, cpg, G,
                                                     chunk, eps, act == 1);
  }
  return static_cast<int>(cudaGetLastError());
}

// Hopper (sm_90a) building blocks shared by the projection GEMM
// (fused_qkv.cu) and the flash attention kernels (flash_hopper.cu at d <= 64,
// flash_split.cu from 72 to 512, flash_transposed.cu on the transposed
// layout): the TMA tensor-map encoder on the host; mbarrier, TMA load/store,
// wgmma and setmaxnreg wrappers on the device; and the flash kernels' common
// steps on a warpgroup's accumulator fragment (online softmax, rescale,
// store).
//
// One shared-memory layout serves every tile here: rows of exactly 128 bytes
// (64 bf16), written by TMA with the 128-byte swizzle, tile bases aligned to
// 1024 bytes (the swizzle repeats every 8 rows).  smem_desc_sw128 describes
// such a tile to wgmma, for a K-major operand (the reduction dimension runs
// along the row: q, k, x, w) and for an MN-major one (the reduction
// dimension runs down the rows: v) alike; the two differ in the
// instruction's transpose bit and in how a 16-deep step moves the start
// address: 32 bytes along the row, or 16 rows = 2048 bytes down.  A tile is at
// most 64 elements wide; a wider operand is several such panels, one wgmma
// (or one TMA box) each.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace gswm_hopper {

typedef __nv_bfloat16 bf16;

constexpr int ROW_BYTES = 128;         // one tile row: 64 bf16
constexpr int ROW_ELEMS = 64;
constexpr int SWIZZLE_SPAN = 1024;     // 8 rows: the swizzle's period and tile alignment
constexpr int DESC_K_STEP = 32 >> 4;   // K-major: 16 elements along the row
constexpr int DESC_MN_STEP = (16 * ROW_BYTES) >> 4;  // MN-major: 16 rows down

// ---------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link:
// it is looked up, once, in the libcuda.so.1 the process (PyTorch) has already
// loaded.  The handle is kept for the life of the process on purpose: the
// function pointer must stay valid for as long.
static inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h == nullptr) {
      fprintf(stderr, "gswm_torch: dlopen(libcuda.so.1) failed: %s\n", dlerror());
      return nullptr;
    }
    void* sym = dlsym(h, "cuTensorMapEncodeTiled");
    if (sym == nullptr)
      fprintf(stderr, "gswm_torch: libcuda.so.1 has no cuTensorMapEncodeTiled (%s): "
                      "this libcuda predates CUDA 12\n", dlerror());
    return reinterpret_cast<EncodeTiledFn>(sym);
  }();
  return fn;
}

// A tensor map over bf16 data of `rank` dimensions, innermost first:
// dims[0] contiguous elements, strides[i] BYTES between steps of dimension
// i + 1 (each a multiple of 16), box the tile one copy moves (box[0] = 64:
// one 128-byte swizzled row).  What a box reads past a dimension arrives as
// zeros; what it would write there is dropped.
static inline cudaError_t encode_map(CUtensorMap* map, const void* base, int rank,
                                     const cuuint64_t* dims, const cuuint64_t* strides,
                                     const cuuint32_t* box) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                        const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) return cudaSuccess;
  fprintf(stderr, "gswm_torch: cuTensorMapEncodeTiled failed with CUresult %d: base %p, "
                  "rank %d, innermost dims %llu x %llu, first stride %llu bytes, box %u x %u\n",
          (int)r, base, rank, (unsigned long long)dims[0], (unsigned long long)dims[1],
          (unsigned long long)strides[0], box[0], box[1]);
  return cudaErrorInvalidValue;
}

// A (d, H, S, B) map over head rows of d bf16 (d % 8 == 0, so every stride
// is a multiple of 16 bytes): head h of row s of batch b starts at base +
// (b * S + s) * pitch + h * d elements; boxes of 64 columns by `rows` rows of
// one head.  Panel j of a head is the box at x = 64 * j: columns from d to
// the panel's end arrive as zeros on a load and are dropped on a store, so a
// head of any width is padded to whole 64-column panels by the copy itself,
// and no box reaches into the next head.
static inline cudaError_t head_map(CUtensorMap* map, const bf16* base, int B, int S, int H,
                                   int d, int pitch, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * sizeof(bf16),
                                 (cuuint64_t)pitch * sizeof(bf16),
                                 (cuuint64_t)S * pitch * sizeof(bf16)};
  const cuuint32_t box[4] = {ROW_ELEMS, 1, (cuuint32_t)rows, 1};
  return encode_map(map, base, 4, dims, strides, box);
}

// -------------------------------------------------------------- device ----

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address of the block's dynamic shared memory.
static __device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  return raw + ((SWIZZLE_SPAN - (smem_u32(raw) & (SWIZZLE_SPAN - 1))) & (SWIZZLE_SPAN - 1));
}

// mbarrier: `count` arrivals (and all bytes announced by expect_tx) complete
// a phase.  A wait on `parity` returns once the phase of that parity is over:
// a fresh barrier passes a wait on 1 at once and blocks a wait on 0.
static __device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

static __device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (done == 0);
}

// One tile, global -> shared, issued by one thread; its bytes complete on
// `bar`.  Coordinates are innermost first, in elements.
static __device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

static __device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

static __device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1, int c2,
                                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One tile, shared -> global; then tma_store_wait before the tile is reused
// or the thread leaves.
static __device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src,
                                                    int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

static __device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src,
                                                    int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

static __device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Shared-memory writes of ordinary stores made visible to TMA and wgmma.
static __device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
static __device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One arrival of the calling threads at barrier `id` of `threads`, without
// waiting: the other side of a named_barrier that only one group waits on.
static __device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// setmaxnreg moves registers between the warpgroups of a block; every warp
// of the warpgroup runs it.
template <int R>
static __device__ __forceinline__ void reg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
static __device__ __forceinline__ void reg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The wgmma descriptor of a tile in the layout above; add DESC_K_STEP or
// DESC_MN_STEP per 16-deep step.
static __device__ __forceinline__ uint64_t smem_desc_sw128(const void* tile) {
  uint64_t d = (uint64_t)((smem_u32(tile) & 0x3FFFFu) >> 4);  // start address
  d |= (uint64_t)1 << 16;                    // leading offset: unused, one atom across
  d |= (uint64_t)(SWIZZLE_SPAN >> 4) << 32;  // stride between 8-row groups
  d |= (uint64_t)1 << 62;                    // 128-byte swizzle
  return d;
}

static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading or moving accumulator registers across an
// asynchronous wgmma: call after wgmma_wait, before the values are used.
template <int N>
static __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register A fragments: called after the wgmma_wait that
// retires the product reading them, it keeps them alive until then, so the
// compiler cannot hand their registers to new values while the tensor cores
// still read them.
template <int N>
static __device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x 128 fp32) = a (64 x 16 bf16, shared, K-major) * b^T (128 x 16
// bf16, shared, K-major) + (accumulate ? d : 0), one warpgroup.
// Accumulator layout (PTX ISA, wgmma D fragment): warp w of the warpgroup
// holds rows 16w..16w+15; with g = lane / 4, t = lane % 4, d[4j], d[4j+1]
// are row 16w+g, columns 8j+2t, 8j+2t+1, and d[4j+2], d[4j+3] row 16w+g+8.
static __device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64 fp32) = a (64 x 16 bf16, shared) * b (16 x 64 bf16, shared) +
// (accumulate ? d : 0), one warpgroup; the accumulator layout above with 8
// column groups.  TRANS_A / TRANS_B = 0: the operand is K-major (q and k of
// (rows, D) tiles); 1: MN-major (q and k of the transposed layout's (D,
// tokens) tiles: the reduction over D runs down the rows).
template <int TRANS_A, int TRANS_B>
static __device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// d (64 x 64 fp32) += a (64 x 16 bf16, registers) * b (16 x 64 bf16, shared),
// one warpgroup.  TRANS_B = 1: b is MN-major (row = reduction index: v of a
// (keys, 64) tile); 0: K-major (v of the transposed layout's (64, keys)
// tile).  The A fragment is
// mma.sync m16n8k16's, per warp: a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..],
// a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..], low half = lower column; two
// neighbouring 8-column groups of the accumulator layout above, rounded to
// bf16, are exactly that.
template <int TRANS_B = 1>
static __device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                          const uint32_t (&a)[4],
                                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d (64 x 48 fp32) += a (64 x 16 bf16, registers) * b (16 x 48 bf16, shared,
// MN-major: v of a (keys, 64) tile, of which the first 48 columns are read),
// one warpgroup; the accumulator layout above with 6 column groups.
static __device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24],
                                                          const uint32_t (&a)[4],
                                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 8 fp32) += a (64 x 16 bf16, registers) * b (16 x 8 bf16, shared,
// MN-major), one warpgroup: d[0], d[1] row 16w+g, d[2], d[3] row 16w+g+8.
static __device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4], const uint32_t (&a)[4],
                                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ------------------------------------ flash attention on the fragment ----
// The steps the flash kernels share.  A thread of a consumer warpgroup holds,
// of its warp's 16 rows, row g = lane / 4 ("lo") and row g + 8 ("hi"), and of
// every 8-column group j the columns 2 * t4 and 2 * t4 + 1 (t4 = lane % 4):
// x[4j], x[4j+1] of the lo row, x[4j+2], x[4j+3] of the hi row.

static __device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 -> one register of two bf16 (lo in the low half), and back.
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

static __device__ __forceinline__ float packed_sum(uint32_t p) {
  return __uint_as_float(p << 16) + __uint_as_float(p & 0xffff0000u);
}

static __device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

static __device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The running max of one key tile of the online softmax (the `use_max`
// recurrence) on the logits fragment s of NG 8-key groups, of which the
// first `valid` keys are real (at least one is): m becomes the new running
// max of the raw logits, and a the factor exp2((m_old - m) * c) the
// accumulator's rows must be scaled by before p v is added (0 on the first
// tile, where m_old = -inf).  Keys past `valid` arrive as zero rows from TMA
// and would have logit 0, not -inf: they are masked here.  Row max is two
// shuffles inside the quad.
template <int NG>
static __device__ __forceinline__ void softmax_max(float (&s)[4 * NG], float& m_lo,
                                                   float& m_hi, float& a_lo, float& a_hi,
                                                   int valid, float c, int t4) {
  if (valid < 8 * NG) {
#pragma unroll
    for (int j = 0; j < NG; ++j) {
      const int col = j * 8 + 2 * t4;
      if (col >= valid) s[4 * j] = s[4 * j + 2] = -INFINITY;
      if (col + 1 >= valid) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
    }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float n_lo = fmaxf(m_lo, quad_max(mx_lo));
  const float n_hi = fmaxf(m_hi, quad_max(mx_hi));
  a_lo = exp2_approx((m_lo - n_lo) * c);
  a_hi = exp2_approx((m_hi - n_hi) * c);
  m_lo = n_lo;
  m_hi = n_hi;
}

// One key tile of the online softmax: p = exp2(s * c - m * c) with the new
// running max m (softmax_max), rounded to bf16 into wgmma's register A
// fragments (16 keys = two neighbouring groups); this thread's share l of
// the row sums of the rounded p is updated.  No logits, p or factor touches
// shared memory, and l stays per thread until the end.
template <int NG>
static __device__ __forceinline__ void softmax_tile(float (&s)[4 * NG],
                                                    uint32_t (&p)[NG / 2][4], float& m_lo,
                                                    float& m_hi, float& l_lo, float& l_hi,
                                                    float& a_lo, float& a_hi, int valid,
                                                    float c, int t4) {
  softmax_max<NG>(s, m_lo, m_hi, a_lo, a_hi, valid, c, t4);
  const float off_lo = -m_lo * c;
  const float off_hi = -m_hi * c;
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int kk = 0; kk < NG / 2; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      p[kk][2 * half] = pack_bf16(exp2_approx(fmaf(s[4 * j], c, off_lo)),
                                  exp2_approx(fmaf(s[4 * j + 1], c, off_lo)));
      p[kk][2 * half + 1] = pack_bf16(exp2_approx(fmaf(s[4 * j + 2], c, off_hi)),
                                      exp2_approx(fmaf(s[4 * j + 3], c, off_hi)));
      sum_lo += packed_sum(p[kk][2 * half]);
      sum_hi += packed_sum(p[kk][2 * half + 1]);
    }
  }
  l_lo = l_lo * a_lo + sum_lo;
  l_hi = l_hi * a_hi + sum_hi;
}

// The same tile in two halves, for a kernel that runs other work between
// them: s becomes p = exp2(s * c - m * c) in place, in fp32
// (softmax_exp), then p is rounded to bf16 into its A fragments
// (softmax_pack); the row sums are the caller's.
template <int NG>
static __device__ __forceinline__ void softmax_exp(float (&s)[4 * NG], float& m_lo,
                                                   float& m_hi, float& a_lo, float& a_hi,
                                                   int valid, float c, int t4) {
  softmax_max<NG>(s, m_lo, m_hi, a_lo, a_hi, valid, c, t4);
  const float off_lo = -m_lo * c;
  const float off_hi = -m_hi * c;
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    s[4 * j] = exp2_approx(fmaf(s[4 * j], c, off_lo));
    s[4 * j + 1] = exp2_approx(fmaf(s[4 * j + 1], c, off_lo));
    s[4 * j + 2] = exp2_approx(fmaf(s[4 * j + 2], c, off_hi));
    s[4 * j + 3] = exp2_approx(fmaf(s[4 * j + 3], c, off_hi));
  }
}

template <int NG>
static __device__ __forceinline__ void softmax_pack(const float (&s)[4 * NG],
                                                    uint32_t (&p)[NG / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NG / 2; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      p[kk][2 * half] = pack_bf16(s[4 * j], s[4 * j + 1]);
      p[kk][2 * half + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  }
}

// The n bf16 of a shared tile (n % 8 == 0, 16-byte aligned) times `scale` in
// fp32, each rounded back to bf16: q scaled by d^-0.5 as the TPU kernels
// scale it.  Thread `first` of `step` takes every step-th 16-byte chunk; the
// swizzle permutes chunks, so an elementwise pass does not care, and the
// zeros TMA filled in stay zeros.  Make the writes visible to wgmma
// (fence_async_smem) and wait for the other threads before the tile is used.
static __device__ __forceinline__ void scale_tile(bf16* tile, int n, float scale, int first,
                                                  int step) {
  uint4* chunks = reinterpret_cast<uint4*>(tile);
  for (int i = first; i < n / 8; i += step) {
    uint4 w = chunks[i];
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      h2[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    chunks[i] = w;
  }
}

// The 64 x (N / 4 * 8) accumulator fragment o with its lo rows times a_lo,
// hi rows times a_hi.
template <int N>
static __device__ __forceinline__ void scale_rows(float (&o)[N], float a_lo, float a_hi) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= a_lo;
    o[4 * j + 1] *= a_lo;
    o[4 * j + 2] *= a_hi;
    o[4 * j + 3] *= a_hi;
  }
}

// The fragment o of N / 4 column groups, rows scaled and rounded to bf16,
// into a 64 x 64 tile laid out as TMA's 128-byte swizzle wants it: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8); columns past the
// fragment's keep what the tile held.  `warp` is the warp's index in its
// warpgroup.
template <int N>
static __device__ __forceinline__ void store_tile_sw128(void* tile_base, const float (&o)[N],
                                                        float inv_lo, float inv_hi, int warp,
                                                        int g, int t4) {
  unsigned char* tile = static_cast<unsigned char*>(tile_base);
  const int r_lo = warp * 16 + g;  // r_lo % 8 == (r_lo + 8) % 8 == g
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int at = ((j ^ g) << 4) + t4 * 4;
    *reinterpret_cast<uint32_t*>(tile + r_lo * ROW_BYTES + at) =
        pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(tile + (r_lo + 8) * ROW_BYTES + at) =
        pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
}

// The log-sum-exp of a consumer's two rows of true logits into lse (B, H, Sq)
// fp32, natural log, at block (h, b) = (blockIdx.y, blockIdx.z): the kernels
// keep the running max m in the units of their raw logits and the row sums l
// of p = exp2(s * c - m * c), so sum_j exp(true logit j) = 2^(m * c) * l and
// lse = m * c * ln 2 + ln l.  One thread a quad writes (t4 == 0); rows at or
// past Sq are padding the TMA store drops, and so is their lse.
static __device__ __forceinline__ void store_lse(float* lse, int Sq, int r_lo, float m_lo,
                                                 float m_hi, float l_lo, float l_hi, float c,
                                                 int t4) {
  if (t4 != 0) return;
  constexpr float LN2 = 0.6931471805599453f;
  float* row = lse + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * Sq;
  if (r_lo < Sq) row[r_lo] = m_lo * c * LN2 + logf(l_lo);
  if (r_lo + 8 < Sq) row[r_lo + 8] = m_hi * c * LN2 + logf(l_hi);
}

}  // namespace gswm_hopper

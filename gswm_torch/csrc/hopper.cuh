// Hopper (sm_90a) building blocks shared by the projection GEMM
// (fused_qkv.cu) and the flash attention kernels (flash_hopper.cu at d <= 64,
// flash_mid.cu from 72 to 160, flash_split.cu from 168 to 512,
// flash_transposed.cu on the transposed layout, whose d <= 48 and
// 64 < d <= 160 run flash_hopper.cu's and flash_mid.cu's kernels): the TMA
// tensor-map encoder on the host; mbarrier, TMA load/store, wgmma and
// setmaxnreg wrappers on the device; the flash kernels' common steps on a
// warpgroup's accumulator fragment (online softmax, rescale, store); the
// transposed layout's boxes loaded and stored by hand where no tensor map
// reaches its rows (S % 8 != 0: cp.async, produce_rows, store_box_rows); the
// three layouts those kernels read (Layout); and the float32 kernels'
// products on the tensor cores (tf32 wgmma, the split of an operand into
// big and small parts: 3xTF32, flash_f32.cu and qkv_proj_f32.cu).
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

#include <type_traits>

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

// A tensor map over bf16 data (or `type`'s) of `rank` dimensions,
// innermost first: dims[0] contiguous elements, strides[i] BYTES between
// steps of dimension i + 1 (each a multiple of 16), box the tile one copy
// moves (box[0] elements: one 128-byte swizzled row, 64 bf16 or 32 floats).
// What a box reads past a dimension arrives as zeros; what it would write
// there is dropped.
static inline cudaError_t encode_map(
    CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank,
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

// A (S, B, d, heads) map over the transposed layout's (heads * d, B, pitch)
// array at `base` (pitch 0: S), tokens innermost (pitch % 8 == 0, so every
// stride is a multiple of 16 bytes): boxes of 64 tokens of one batch by 64
// rows of one head, panel j at row 64 j.  Rows from d to the panel's end
// arrive as zeros on a load and are dropped on a store, so no box reaches
// into the next head's rows; tokens past S arrive as zeros (whatever a pitch
// wider than S holds there) and never from batch b + 1.  A box lands as 64
// rows (of d) of 128 bytes (64 tokens) in the one layout.
static inline cudaError_t band_map(CUtensorMap* map, const bf16* base, int heads, int d, int B,
                                   int S, int pitch = 0) {
  const cuuint64_t ld = pitch ? pitch : S;
  const cuuint64_t dims[4] = {(cuuint64_t)S, (cuuint64_t)B, (cuuint64_t)d,
                              (cuuint64_t)heads};
  const cuuint64_t strides[3] = {ld * sizeof(bf16), (cuuint64_t)B * ld * sizeof(bf16),
                                 (cuuint64_t)d * B * ld * sizeof(bf16)};
  const cuuint32_t box[4] = {ROW_ELEMS, 1, ROW_ELEMS, 1};
  return encode_map(map, base, 4, dims, strides, box);
}

// The streaming multiprocessors of the current device: the launchers size
// their blocks so that the grid fills them.
static inline cudaError_t multiprocessors(int* count) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
  return e;
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

// A consumer's wait for a full barrier.  By hand (ROWS), the tiles were
// written by cp.async and plain stores, which wgmma (the async proxy) sees
// only after a proxy fence on the reading side.
template <bool ROWS>
static __device__ __forceinline__ void wait_full(uint64_t* bar, uint32_t parity) {
  mbar_wait(bar, parity);
  if constexpr (ROWS) fence_async_smem();
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

// d (64 x 48 fp32) += a (64 x 16 bf16, registers) * b (16 x 48 bf16,
// shared), one warpgroup; the accumulator layout above with 6 column groups.
// TRANS_B = 1: b is MN-major, v of a (keys, 64) tile, of which the first 48
// columns of each 128-byte swizzled row are read; 0: K-major, v of the
// transposed layout's (64, keys) tile, of which the first 48 rows are read.
// The N = 32 and 16 wrappers below read the first N columns or rows alike.
template <int TRANS_B = 1>
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
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d (64 x 32 fp32) += a (64 x 16 bf16, registers) * b (16 x 32 bf16,
// shared), one warpgroup; the accumulator layout above with 4 column groups.
// TRANS_B as wgmma_m64n48k16_rs's.
template <int TRANS_B = 1>
static __device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                          const uint32_t (&a)[4],
                                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
}

// d (64 x 16 fp32) += a (64 x 16 bf16, registers) * b (16 x 16 bf16,
// shared), one warpgroup; the accumulator layout above with 2 column groups.
// TRANS_B as wgmma_m64n48k16_rs's.
template <int TRANS_B = 1>
static __device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                          const uint32_t (&a)[4],
                                                          uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TRANS_B));
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

// The fragment o of 64 tokens by N / 4 groups of 8 rows (of d), tokens
// scaled and rounded to bf16, transposed into a (64 rows, 64 tokens) panel
// as TMA's 128-byte swizzle wants it: row r, token c at 16-byte chunk
// (c / 8) ^ (r % 8) of the row.  Rows past the fragment's keep what the
// panel held.
template <int N>
static __device__ __forceinline__ void store_tile_transposed(void* panel, const float (&o)[N],
                                                             float inv_lo, float inv_hi,
                                                             int warp, int g, int t4) {
  unsigned char* tile = static_cast<unsigned char*>(panel);
  const int c_lo = warp * 16 + g;  // c_lo % 8 == (c_lo + 8) % 8 == g
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * j + 2 * t4 + e;
      unsigned char* row = tile + r * ROW_BYTES + g * 2;
      *reinterpret_cast<bf16*>(row + (((c_lo >> 3) ^ (r & 7)) << 4)) =
          __float2bfloat16(o[4 * j + e] * inv_lo);
      *reinterpret_cast<bf16*>(row + ((((c_lo >> 3) + 1) ^ (r & 7)) << 4)) =
          __float2bfloat16(o[4 * j + 2 + e] * inv_hi);
    }
  }
}

// ------------------------------------------------------ boxes by hand ----
// Where S % 8 != 0 the transposed layout's rows start at any even byte
// address and its strides (S * 2 and B * S * 2 bytes) are no multiples of
// 16, so no tensor map can address them.  There a box (64 rows of d by 64
// tokens, the transposed layout's TMA box) is loaded by the 128 threads of
// the producer warpgroup and a consumer's output panel stored by the 128
// threads of its warpgroup, through the one layout above (token c of row r
// at 16-byte chunk (c / 8) ^ (r % 8) of the row), so the consumers' wgmma
// loops do not change:
//   * thread t of the warpgroup takes chunk c = t % 8 (tokens 8c ... 8c + 7
//     of the box) of rows 16 p + t / 8, p = 0 ... 3.  Its four rows lie
//     16 B S elements apart, so they start the same a elements into an
//     aligned 16-byte word (0 or 4 at SD's level 2, where S % 8 == 4);
//   * even a: the chunk goes by cp.async (no register holds it in flight)
//     straight to its place in pieces of 16, 8 or 4 bytes (a = 0, a % 4 ==
//     0, else), each piece reading the tokens of the box below S alone and
//     zero-filling the rest, rows at or past d zero-filled whole.  A box
//     wholly below S (all but a row's last) takes whole pieces with no
//     check a piece, and none a row where the box lies below d too: the
//     producer's instructions a copy are what the copies' rate is bound by;
//   * odd a: whole aligned 16-byte words, each only where it holds a token
//     of the box below S in a row below d (never a word without an element
//     of the array), are copied into the tile row as they lie (word k at
//     byte 16 k; the ninth, which the row's thread c = 7 copies, to a side
//     buffer of 16 bytes a row); once they landed each row is shifted into
//     place: chunk c is words c and c + 1 (the next thread's, by a shuffle,
//     or the ninth) moved by a elements (selects and a byte permute), written
//     to chunk c ^ (r % 8) once the row's eight threads have read their
//     words; tokens at or past S and rows at or past d become zeros, as a
//     tensor map's out-of-bounds fill gives them;
//   * each producer thread arrives once on a set's full barrier (an init
//     count of 128): at an even a its copies arrive as they land
//     (cp.async.mbarrier.arrive), so it never waits for them and runs ahead
//     as far as the ring's empty barriers let it; at an odd a it arrives
//     after shifting the set into place, the next sets' copies in flight
//     meanwhile (produce_rows);
//   * the consumers make the tiles visible to wgmma after each wait on a
//     full barrier (wait_full: a proxy fence on the reading side, where the
//     writes were cp.async copies and plain stores);
//   * the store writes tokens below S of rows below d alone, in 2-byte
//     stores and 4-byte stores of aligned pairs: the chunks at a row's ends
//     hold neighbouring query blocks' and the next batch's tokens, which no
//     wider store or read-modify-write may touch.

// A (heads * d, B, S) array of the transposed layout, addressed by hand:
// row r of head hh, batch b starts at base + ((hh * d + r) * B + b) * S
// elements.  A kernel's inputs are only read through it.
struct BandRows {
  bf16* base;
  int B, S, d;
};

static __device__ __forceinline__ bf16* band_row(const BandRows& a, int hh, int r, int b) {
  return a.base + ((size_t)(hh * a.d + r) * a.B + b) * a.S;
}

// cp.async of 16 (L2 only), 8 or 4 bytes (through L1): whole, or the first
// `bytes` read from src and the rest zero-filled.
static __device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// the same under an L2 cache policy (`createpolicy`; say, evict-first for a
// copy read once)
static __device__ __forceinline__ void cp_async_16_hinted(void* dst, const void* src,
                                                          uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "l"(policy)
               : "memory");
}

static __device__ __forceinline__ void cp_async_8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies of all but the N most recent groups have landed
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One arrival on `bar` once every cp.async this thread has issued landed
// (one of the arrivals its init count expects).
static __device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

constexpr int ROWS_SIDE_BYTES = ROW_ELEMS * 16;  // a box's ninth words, 16 bytes a row

// A box: its tile (64 rows of 128 bytes in the one layout), the side
// buffer of its ninth words, and rows [r0, r0 + 64) of head hh, tokens
// [tok0, tok0 + 64) it holds.
struct RowsBox {
  void* tile;
  void* side;
  int hh, r0, tok0;
};

// This thread's first row of box x (row t / 8), and how many elements it
// (and so each of the thread's rows) starts into an aligned 16-byte word.
static __device__ __forceinline__ const bf16* rows_first(const RowsBox& x, const BandRows& src,
                                                         int b, int& a) {
  const bf16* row = band_row(src, x.hh, x.r0 + ((threadIdx.x & 127) >> 3), b) + x.tok0;
  a = (int)(reinterpret_cast<uintptr_t>(row) >> 1) & 7;
  return row;
}

// This thread's copies of box x.
static __device__ __forceinline__ void rows_copy(const RowsBox& x, const BandRows& src, int b) {
  const int t = threadIdx.x & 127;
  const int c = t & 7;
  const int n = min(src.S - x.tok0, ROW_ELEMS);  // tokens of the box below S
  const size_t step = (size_t)16 * src.B * src.S;  // elements between the thread's rows
  int a;
  const bf16* first = rows_first(x, src, b, a);
  unsigned char* tile = static_cast<unsigned char*>(x.tile);
  unsigned char* side = static_cast<unsigned char*>(x.side);
  if (!(a & 1) && n == ROW_ELEMS) {
    // a box below S: a row below d takes whole pieces, one past d a
    // zero-filled chunk (nothing read); the chunk's place is the same in
    // each of the thread's rows (16 rows apart, so r % 8 alike)
    const bf16* from = first + 8 * c;
    unsigned char* dst = tile + (t >> 3) * ROW_BYTES + ((c ^ ((t >> 3) & 7)) << 4);
    auto whole = [&](unsigned char* to, const bf16* at) {
      if (a == 0) {
        cp_async_16(to, at);
      } else if (a == 4) {
        cp_async_8(to, at);
        cp_async_8(to + 8, at + 4);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) cp_async_4(to + 4 * i, at + 2 * i);
      }
    };
    if (x.r0 + ROW_ELEMS <= src.d) {  // every row below d: no check a row
#pragma unroll
      for (int p = 0; p < 4; ++p) whole(dst + p * 16 * ROW_BYTES, from + p * step);
    } else {
      const void* none =
          reinterpret_cast<const void*>(reinterpret_cast<uintptr_t>(first) & ~15ull);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (x.r0 + 16 * p + (t >> 3) < src.d)
          whole(dst + p * 16 * ROW_BYTES, from + p * step);
        else
          cp_async_16(dst + p * 16 * ROW_BYTES, none, 0);
      }
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = 16 * p + (t >> 3);
    const bool live = n > 0 && x.r0 + row < src.d;
    const bf16* rp = first + p * step;
    if (a & 1) {  // whole words as they lie; rows_place shifts them
      if (!live) continue;
      const uint4* w = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(rp) & ~15ull);
      if (8 * c - a < n) cp_async_16(tile + row * ROW_BYTES + 16 * c, w + c);
      if (c == 7 && ROW_ELEMS - a < n) cp_async_16(side + row * 16, w + 8);
    } else {  // the chunk in place; tokens past S and rows past d zero-filled
      unsigned char* dst = tile + row * ROW_BYTES + ((c ^ (row & 7)) << 4);
      const int m = live ? min(max(n - 8 * c, 0), 8) : 0;  // tokens to read
      const bf16* from = m > 0 ? rp + 8 * c : src.base;    // nothing read where m == 0
      if (a == 0) {
        cp_async_16(dst, from, 2 * m);
      } else if (a == 4) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          cp_async_8(dst + 8 * i, m > 4 * i ? from + 4 * i : from, 2 * min(max(m - 4 * i, 0), 4));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cp_async_4(dst + 4 * i, m > 2 * i ? from + 2 * i : from, 2 * min(max(m - 2 * i, 0), 2));
      }
    }
  }
}

// Box x, once this thread's copies of it landed: an odd a's rows shifted
// into place (an even a's are there).  The shuffles and the warp barrier
// span the eight threads of the row.
static __device__ __forceinline__ void rows_place(const RowsBox& x, const BandRows& src, int b) {
  const int t = threadIdx.x & 127;
  const int c = t & 7;
  int a;
  rows_first(x, src, b, a);
  if (!(a & 1)) return;
  const unsigned group = 0xffu << (threadIdx.x & 24);  // the row's eight lanes
  const int m = min(src.S - x.tok0, ROW_ELEMS) - 8 * c;  // tokens of the chunk below S
  unsigned char* tile = static_cast<unsigned char*>(x.tile);
  const unsigned char* side = static_cast<const unsigned char*>(x.side);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = 16 * p + (t >> 3);
    const uint4 raw = *reinterpret_cast<const uint4*>(tile + row * ROW_BYTES + 16 * c);
    uint4 ninth = make_uint4(0u, 0u, 0u, 0u);
    if (c == 7) ninth = *reinterpret_cast<const uint4*>(side + row * 16);
    // word c + 1: the next thread's word c, or the ninth
    const uint32_t lw[4] = {raw.x, raw.y, raw.z, raw.w};
    const uint32_t nw[4] = {ninth.x, ninth.y, ninth.z, ninth.w};
    uint32_t wd[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t next = __shfl_down_sync(group, lw[i], 1, 8);
      wd[i] = lw[i];
      wd[4 + i] = c < 7 ? next : nw[i];
    }
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (x.r0 + row < src.d && m > 0) {
      // elements a ... a + 7 of the 16 in wd: by 4, by 2, then by 1
      uint32_t v4[6], v2[5], o[4];
#pragma unroll
      for (int i = 0; i < 6; ++i) v4[i] = (a & 4) ? wd[i + 2] : wd[i];
#pragma unroll
      for (int i = 0; i < 5; ++i) v2[i] = (a & 2) ? v4[i + 1] : v4[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = __byte_perm(v2[i], v2[i + 1], 0x5432u);  // a is odd
        // tokens at or past S are zeros
        o[i] &= 2 * i + 1 < m ? 0xffffffffu : 2 * i < m ? 0x0000ffffu : 0u;
      }
      out = make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncwarp(group);  // the row's eight threads have read their words
    *reinterpret_cast<uint4*>(tile + row * ROW_BYTES + ((c ^ (row & 7)) << 4)) = out;
  }
}

// The N boxes of one set, box(i) the i-th: copied, then one commit group;
// where the thread's rows start at an even a its copies are the boxes'
// last word, and their landing is its arrival on the set's full barrier.
template <int N, typename BoxFn>
static __device__ __forceinline__ void rows_copy_set(const BandRows& src, int b, BoxFn box,
                                                     bool odd, uint64_t* full) {
#pragma unroll
  for (int i = 0; i < N; ++i) rows_copy(box(i), src, b);
  if (!odd) cp_async_arrive(full);
  cp_async_commit();
}

// An odd a's set, once its copies landed: shifted into place, made visible
// to wgmma, and the thread's arrival on the set's full barrier.
template <int N, typename BoxFn>
static __device__ __forceinline__ void rows_place_set(const BandRows& src, int b, BoxFn box,
                                                      bool odd, uint64_t* full) {
  if (!odd) return;
#pragma unroll
  for (int i = 0; i < N; ++i) rows_place(box(i), src, b);
  fence_async_smem();
  mbar_arrive(full);
}

// setmaxnreg budgets of a hand-loaded instantiation with NWG consumer
// warpgroups: its producer's 128 threads compute every copy's addresses and
// shift odd rows, so it takes registers from the consumers, the block staying
// within its share of the SM's 64K (one consumer warpgroup, two blocks an
// SM: 56 + 200 = 2 x 128; two: 72 + 2 x 216 = 3 x 168; three: 32 + 3 x 160 =
// 4 x 128).  The tensor maps' instantiations keep 24 or 40 and 232 (160 at
// three).
template <int NWG>
constexpr int ROWS_PRODUCER_REGS = NWG == 1 ? 56 : NWG == 2 ? 72 : 32;
template <int NWG>
constexpr int ROWS_CONSUMER_REGS = NWG == 1 ? 200 : NWG == 2 ? 216 : 160;

// The shared memory a hand-loaded instantiation takes beyond its tiles: the
// side buffers of NQ boxes of q and of NKV boxes of k and of v a stage.
template <int NQ, int NKV, int STAGES>
constexpr int ROWS_SIDE = (NQ + 2 * STAGES * NKV) * ROWS_SIDE_BYTES;

// Side buffer i of that room: q's NQ boxes first (box i at i *
// ROWS_SIDE_BYTES), then stage s's k boxes and its v boxes (kv = 0, 1).
template <int NQ, int NKV>
static __device__ __forceinline__ void* rows_side(unsigned char* room, int s, int kv, int i) {
  return room + (NQ + (2 * s + kv) * NKV + i) * ROWS_SIDE_BYTES;
}

// The producer warpgroup of a hand-loaded instantiation, all 128 threads:
// NQ boxes of q, then for each of `tiles` key tiles NKV boxes of k and of v
// through a ring of STAGES stages.  q_box(i), k_box(t, i) and v_box(t, i)
// place box i of a set (tile t's in stage t % STAGES); wait_k(t) and
// wait_v(t) wait until the consumers have released stage t % STAGES's k and
// v for tile t.  A thread whose rows start at an even a never waits for its
// copies: each set's copies arrive on its full barrier as they land.  An odd
// a's thread shifts a set into place once its copies landed, with the next
// sets' copies in flight: from two stages on, tile t + 1's k (v) is copied
// before tile t's k (v) is placed, an empty group standing for it after the
// last tile, so the wait always leaves two groups in flight.  The consumers
// release a stage's k before they need the next tile's v, and its v before
// they need the tile after, so no wait here stands on a hand-off that comes
// after it.
template <int NQ, int NKV, int STAGES, typename QBox, typename KBox, typename VBox,
          typename WaitK, typename WaitV>
static __device__ __forceinline__ void produce_rows(const BandRows& qs, const BandRows& ks,
                                                    const BandRows& vs, int b, int tiles,
                                                    QBox q_box, KBox k_box, VBox v_box,
                                                    WaitK wait_k, WaitV wait_v,
                                                    uint64_t* full_q, uint64_t* full_k,
                                                    uint64_t* full_v) {
  // the same for every box: the bands and the boxes' rows and tokens start
  // at multiples of 8 elements from each other
  int a;
  rows_first(q_box(0), qs, b, a);
  const bool odd = a & 1;
  rows_copy_set<NQ>(qs, b, q_box, odd, full_q);
  wait_k(0);
  rows_copy_set<NKV>(ks, b, [&](int i) { return k_box(0, i); }, odd, full_k);
  if (odd) cp_async_wait<1>();
  rows_place_set<NQ>(qs, b, q_box, odd, full_q);
  wait_v(0);
  rows_copy_set<NKV>(vs, b, [&](int i) { return v_box(0, i); }, odd, full_v);
  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    const int s1 = (t + 1) % STAGES;
    auto kt = [&](int i) { return k_box(t, i); };
    auto vt = [&](int i) { return v_box(t, i); };
    if constexpr (STAGES > 1) {
      if (t + 1 < tiles) {
        wait_k(t + 1);
        rows_copy_set<NKV>(ks, b, [&](int i) { return k_box(t + 1, i); }, odd, full_k + s1);
      } else {
        cp_async_commit();
      }
      if (odd) cp_async_wait<2>();
      rows_place_set<NKV>(ks, b, kt, odd, full_k + s);
      if (t + 1 < tiles) {
        wait_v(t + 1);
        rows_copy_set<NKV>(vs, b, [&](int i) { return v_box(t + 1, i); }, odd, full_v + s1);
      } else {
        cp_async_commit();
      }
      if (odd) cp_async_wait<2>();
      rows_place_set<NKV>(vs, b, vt, odd, full_v + s);
    } else {  // one stage: tile t + 1 lands where tile t is read
      if (odd) cp_async_wait<1>();
      rows_place_set<NKV>(ks, b, kt, odd, full_k);
      if (odd) cp_async_wait<0>();
      rows_place_set<NKV>(vs, b, vt, odd, full_v);
      if (t + 1 < tiles) {
        wait_k(t + 1);
        rows_copy_set<NKV>(ks, b, [&](int i) { return k_box(t + 1, i); }, odd, full_k);
        wait_v(t + 1);
        rows_copy_set<NKV>(vs, b, [&](int i) { return v_box(t + 1, i); }, odd, full_v);
      }
    }
  }
  cp_async_wait<0>();  // nothing of this thread's left in flight when it leaves
}

// A consumer's output panel at src (64 rows of d by 64 tokens, transposed as
// store_tile_transposed leaves it) into rows [r0, r0 + 64) of head hh,
// tokens [tok0, tok0 + 64) of batch b: rows below d and tokens below S
// alone, by the warpgroup's 128 threads, after the panel is complete.
static __device__ __forceinline__ void store_box_rows(const void* src, const BandRows& dst,
                                                      int hh, int r0, int tok0, int b) {
  const int t = threadIdx.x & 127;
  const int c = t & 7;
  const int m = min(dst.S - tok0 - 8 * c, 8);  // tokens of the chunk below S
  const unsigned char* tile = static_cast<const unsigned char*>(src);
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int row = 16 * p + (t >> 3);
    if (m <= 0 || r0 + row >= dst.d) continue;
    const uint4 v =
        *reinterpret_cast<const uint4*>(tile + row * ROW_BYTES + ((c ^ (row & 7)) << 4));
    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
    bf16* out = band_row(dst, hh, r0 + row, b) + tok0 + 8 * c;
    unsigned short* out16 = reinterpret_cast<unsigned short*>(out);
    if ((reinterpret_cast<uintptr_t>(out) & 3) == 0) {  // pairs 2i, 2i + 1 aligned
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (2 * i + 1 < m)
          *reinterpret_cast<uint32_t*>(out + 2 * i) = wd[i];
        else if (2 * i < m)
          out16[2 * i] = (unsigned short)(wd[i] & 0xffffu);
      }
    } else {  // element 0 alone, then pairs 2i + 1, 2i + 2 aligned
      out16[0] = (unsigned short)(wd[0] & 0xffffu);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (2 * i + 2 < m)
          *reinterpret_cast<uint32_t*>(out + 2 * i + 1) = __byte_perm(wd[i], wd[i + 1], 0x5432u);
        else if (2 * i + 1 < m)
          out16[2 * i + 1] = (unsigned short)(wd[i] >> 16);
      }
      if (7 < m) out16[7] = (unsigned short)(wd[3] >> 16);
    }
  }
}

// ----------------------------------------------------- the three layouts ----
// The flash kernels of flash_hopper.cu (narrow), flash_mid.cu and
// flash_split.cu take the layout as a template parameter; it decides the tensor maps' coordinates,
// which way round wgmma reads q, k and v, and the epilogue's store, and
// nothing else.
//   natural:    q, k, v, out (B, S, H, d) (hopper.cuh head_map): a tile row
//               is a token, 64 columns of d; q and k K-major, v MN-major.
//   transposed: the (3 H d, B, S) stacked projection output and its (H d, B,
//               S) output (band_map): a tile row is a row of d, 64 tokens;
//               q and k MN-major, v K-major, and a k or v tile of 128 keys
//               is two 64-token boxes side by side.
//   rows:       the transposed layout at any S (S % 8 != 0 among them), its
//               boxes loaded and stored by hand (BandRows, above): the same
//               tiles in shared memory, the same products in the same order.
enum class Layout { natural, transposed, rows };

// What a kernel's operand is: a tensor map, or the array addressed by hand.
template <Layout L>
using Operand = typename std::conditional<L == Layout::rows, BandRows, CUtensorMap>::type;

// Panel j (64 columns, or rows, of d) of `tok`'s box of head h, batch b:
// one TMA copy by one thread whose bytes complete on `bar` (by hand, the
// producer warpgroup runs produce_rows instead).
template <Layout L>
static __device__ __forceinline__ void tma_load_panel(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int j, int h, int tok,
                                                      int b) {
  static_assert(L != Layout::rows, "boxes by hand: produce_rows");
  if constexpr (L == Layout::natural)
    tma_load_4d(dst, map, bar, j * ROW_ELEMS, h, tok, b);
  else
    tma_load_4d(dst, map, bar, tok, b, j * ROW_ELEMS, h);
}

// One thread stores the panel by TMA; by hand (rows), every thread of the
// consumer warpgroup calls this after the panel is complete.
template <Layout L, typename Map>
static __device__ __forceinline__ void tma_store_panel(const Map* map, const void* src, int j,
                                                       int h, int tok, int b) {
  if constexpr (L == Layout::natural)
    tma_store_4d(map, src, j * ROW_ELEMS, h, tok, b);
  else if constexpr (L == Layout::transposed)
    tma_store_4d(map, src, tok, b, j * ROW_ELEMS, h);
  else
    store_box_rows(src, *map, h, j * ROW_ELEMS, tok, b);
}

// The output fragment of 64 rows by N / 4 column groups into a panel of the
// warpgroup's q tile: as it lies (natural), or transposed.
template <Layout L, int N>
static __device__ __forceinline__ void store_tile_out(void* panel, const float (&o)[N],
                                                      float inv_lo, float inv_hi, int warp,
                                                      int g, int t4) {
  if constexpr (L == Layout::natural)
    store_tile_sw128(panel, o, inv_lo, inv_hi, warp, g, t4);
  else
    store_tile_transposed(panel, o, inv_lo, inv_hi, warp, g, t4);
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

// ------------------------------- float32 products on the tensor cores ----
// wgmma has no fp32 form; its tf32 one reads 19 bits of each 32-bit operand
// (sign, 8 of exponent, 10 of mantissa), 8 deep a step: 32 bytes of a row,
// as a bf16 step's 16, so smem_desc_sw128 and DESC_K_STEP serve a tile of
// floats as they stand (a 128-byte swizzled row holds 32 floats).  PTX gives
// tf32 no transpose bit: every operand read from shared memory lies K-major.
// A product of float32 accuracy is three of them ("3xTF32"): each operand x
// split into big = tf32(x) and small = tf32(x - big), both rounded to
// nearest (ties away) by cvt.rna, so no low bits are left for the tensor
// core to treat as it likes; then small * big + big * small + big * big
// into one fp32 accumulator, small terms first (CUTLASS's order).  That
// keeps about 21 of fp32's 24 bits of each product; the split itself leaves
// |x - big - small| <= 2^-22 |x| (ops.attention.split_tf32 is its plain
// model).

static __device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d (64 x N fp32) (+)= a (64 x 8 tf32, registers) * b (8 x N tf32, shared,
// K-major: N rows of which each 32-byte step reads 8 floats), one
// warpgroup; the accumulator layout of the bf16 wrappers above.  The A
// fragment, per warp: a[0] = A[g][t], a[1] = A[g + 8][t], a[2] = A[g][t + 4],
// a[3] = A[g + 8][t + 4] (g = lane / 4, t = lane % 4).
static __device__ __forceinline__ void wgmma_tf32_m64n128k8_rs(float (&d)[64],
                                                              const uint32_t (&a)[4],
                                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

static __device__ __forceinline__ void wgmma_tf32_m64n64k8_rs(float (&d)[32],
                                                              const uint32_t (&a)[4],
                                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

static __device__ __forceinline__ void wgmma_tf32_m64n40k8_rs(float (&d)[20],
                                                              const uint32_t (&a)[4],
                                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

static __device__ __forceinline__ void wgmma_tf32_m64n32k8_rs(float (&d)[16],
                                                              const uint32_t (&a)[4],
                                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

static __device__ __forceinline__ void wgmma_tf32_m64n16k8_rs(float (&d)[8],
                                                              const uint32_t (&a)[4],
                                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int N>
static __device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int accumulate) {
  if constexpr (N == 128) wgmma_tf32_m64n128k8_rs(d, a, desc_b, accumulate);
  else if constexpr (N == 64) wgmma_tf32_m64n64k8_rs(d, a, desc_b, accumulate);
  else if constexpr (N == 40) wgmma_tf32_m64n40k8_rs(d, a, desc_b, accumulate);
  else if constexpr (N == 32) wgmma_tf32_m64n32k8_rs(d, a, desc_b, accumulate);
  else {
    static_assert(N == 16, "tf32 wgmma wrappers: N = 16, 32, 40, 64, 128");
    wgmma_tf32_m64n16k8_rs(d, a, desc_b, accumulate);
  }
}

// One 8-deep step of d (+)= a * b in 3xTF32: a's parts in registers
// (split_tf32 of its A fragment), b's big and small parts as two K-major
// tiles of one shape; small * big, big * small, big * big.
template <int N>
static __device__ __forceinline__ void wgmma_3xtf32_rs(float (&d)[N / 2],
                                                       const uint32_t (&a_big)[4],
                                                       const uint32_t (&a_small)[4],
                                                       uint64_t b_big, uint64_t b_small,
                                                       int accumulate) {
  wgmma_tf32_rs<N>(d, a_small, b_big, accumulate);
  wgmma_tf32_rs<N>(d, a_big, b_small, 1);
  wgmma_tf32_rs<N>(d, a_big, b_big, 1);
}

// The A fragment of four floats split into its big and small parts.
static __device__ __forceinline__ void split_fragment(float x0, float x1, float x2, float x3,
                                                      uint32_t (&big)[4], uint32_t (&small)[4]) {
  split_tf32(x0, big[0], small[0]);
  split_tf32(x1, big[1], small[1]);
  split_tf32(x2, big[2], small[2]);
  split_tf32(x3, big[3], small[3]);
}

}  // namespace gswm_hopper

// The launchers the flash-attention sources call across files: the split
// launcher (flash_split.cu), which the fused-qkv kernel (fused_qkv.cu)
// launches after its projections, and the launchers it dispatches to:
// d <= 64 (flash_hopper.cu) and 64 < d <= 160 (flash_mid.cu); and the
// transposed layout's launchers of those three kernels, which
// flash_transposed.cu dispatches to at d <= 48 and 64 < d <= 160 (by tensor
// maps or with the boxes by hand) and at d > 160 (by tensor maps, over
// scratch of an aligned token pitch where S % 8 != 0).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); bf16, natural layout, rows
// 16-byte aligned; D % 8 == 0, 8 <= D <= 512.  out = softmax(q k^T /
// sqrt(D)) v per (batch, head), exact softmax (running max).  With lse (fp32
// (B, H, Sq)), each row's log-sum-exp of q k^T / sqrt(D) too; nullptr: the
// kernels without that store.
cudaError_t gswm_launch_flash_split(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* out,
                                    int B, int Sq, int Sk, int H, int D,
                                    cudaStream_t stream, float* lse = nullptr);

// The same function at head dim d (d % 8 == 0, 8 <= d <= 64) with a base
// pointer per operand and ld_q, ld_kv, ld_o elements (multiples of 8)
// between rows of q, of k and v, and of out; head h starts at column h * d
// of each.
cudaError_t gswm_launch_flash_hopper(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, __nv_bfloat16* out,
                                     int B, int Sq, int Sk, int H, int d, int ld_q,
                                     int ld_kv, int ld_o, cudaStream_t stream,
                                     float* lse = nullptr);

// The same function at head dim d with 64 < d <= 160 (d % 8 == 0), the
// arguments as gswm_launch_flash_hopper's.
cudaError_t gswm_launch_flash_mid(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, __nv_bfloat16* out, int B,
                                  int Sq, int Sk, int H, int d, int ld_q, int ld_kv,
                                  int ld_o, cudaStream_t stream, float* lse = nullptr);

// The transposed layout (flash_transposed.cu): qkv_t (3 H d, B, S) bf16,
// q, k and v its row bands [0, H d), [H d, 2 H d) and [2 H d, 3 H d), head
// h at rows h d ... of its band; out_t (H d, B, S); 16-byte aligned.
// out = softmax(q k^T / sqrt(d)) v per (batch, head), no lse.  rows: the
// boxes loaded and stored by hand (hopper.cuh Layout::rows), any S; else by
// tensor maps, S % 8 == 0.  flash_hopper.cu's narrow kernel at 8 <= d <= 48 ...
cudaError_t gswm_launch_flash_narrow_transposed(const __nv_bfloat16* qkv_t,
                                                __nv_bfloat16* out_t, int B, int S, int H,
                                                int d, bool rows, cudaStream_t stream);

// ... and flash_mid.cu's kernel at 64 < d <= 160.
cudaError_t gswm_launch_flash_mid_transposed(const __nv_bfloat16* qkv_t, __nv_bfloat16* out_t,
                                             int B, int S, int H, int d, bool rows,
                                             cudaStream_t stream);

// ... and flash_split.cu's kernel at 160 < d <= 512 by tensor maps: qkv the
// (3 H d, B, pitch) stacked bands, pitch % 8 == 0 and pitch >= S (tokens
// from S to the pitch are never read); the (H d, B, S) output stored by
// hand (any S) or by TMA (S % 8 == 0).
cudaError_t gswm_launch_flash_split_transposed(const __nv_bfloat16* qkv, int pitch,
                                               __nv_bfloat16* out, bool out_by_hand, int B,
                                               int S, int H, int d, cudaStream_t stream);

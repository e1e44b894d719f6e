// The launchers the flash-attention sources call across files: the split
// launcher (flash_split.cu), which the fused-qkv kernel (fused_qkv.cu)
// launches after its projections, and the d <= 64 launcher (flash_hopper.cu)
// it dispatches to.
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

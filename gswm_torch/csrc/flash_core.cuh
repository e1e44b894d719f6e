// Shared declaration of the split flash-attention kernel (flash_split.cu),
// which the fused-qkv kernel (fused_qkv.cu) launches after its projections.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); bf16, natural layout, rows
// 16-byte aligned; D a multiple of 64 up to 512.  out = softmax(q k^T /
// sqrt(D)) v per (batch, head), exact softmax (running max).
cudaError_t gswm_launch_flash_split(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* out,
                                    int B, int Sq, int Sk, int H, int D,
                                    cudaStream_t stream);

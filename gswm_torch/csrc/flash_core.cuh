// Shared declaration of the flash-attention core (flash_attn.cu), which the
// fused-qkv kernel (fused_qkv.cu) launches after its projections.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// q, k, v, out: (B, S, H * 64) bf16, natural layout, rows 16-byte aligned.
// out = softmax(q k^T / 8) v per head, exact softmax (running max).
cudaError_t gswm_launch_flash(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* out,
                              int B, int S, int H, cudaStream_t stream);

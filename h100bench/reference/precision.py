"""The arithmetic the reference computes its products in.

The reference is float32 with TF32 off. Its control, which has to come out
as not correct, is the same code one precision below the one a part's
configuration states: fp8 (e4m3, one scale a tensor) under a bfloat16 UNet
and VAE, TF32 under the float32 text encoders, bfloat16 under the float32
embed. Every operand of a product (a linear layer, a convolution, an
attention matmul) is rounded to that precision and the product summed in
float32, as the tensor cores do; norms, softmax and the scheduler stay
float32.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa, to nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x scaled so its largest magnitude is fp8's largest, rounded to e4m3
    and scaled back."""
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """Rounds the operands of products: ``fp32`` leaves them alone."""

    ROUND = {"fp32": None, "tf32": _round_tf32, "fp8": _round_fp8,
             "bf16": lambda x: x.to(torch.bfloat16).float()}

    def __init__(self, name: str = "fp32"):
        if name not in self.ROUND:
            raise ValueError(f"precision {name!r}: one of {sorted(self.ROUND)}")
        self.name = name
        self._round = self.ROUND[name]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._round is None else self._round(x)


FP32 = Precision("fp32")


def set_precision(module: torch.nn.Module, precision: Precision) -> torch.nn.Module:
    """Give every submodule of ``module`` that rounds products ``precision``."""
    for m in module.modules():
        if hasattr(m, "prec"):
            m.prec = precision
    return module


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN within the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

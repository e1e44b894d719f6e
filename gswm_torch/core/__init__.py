"""L1 watermark core in PyTorch: ChaCha20 keystream, bit diffusion, embed and
decode.  Counterpart of ``gswm.core``; the keystream runs as a CUDA kernel on
the card (``gswm_torch.core.chacha``)."""

from gswm_torch.core.capacity import choose_watermark_length  # noqa: F401

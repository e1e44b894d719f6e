"""Evaluation of the PyTorch port: bit accuracy, the key registry and the
trace search, the robustness sweep, detection statistics, report writers and
prompt sets."""

from gswm_torch.eval.metrics import bit_accuracy_bits, calculate_bit_accuracy  # noqa: F401

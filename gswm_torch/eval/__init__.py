"""Evaluation of the PyTorch port: bit accuracy, the key registry and the
trace search, the robustness sweep, detection statistics, report writers and
prompt sets."""

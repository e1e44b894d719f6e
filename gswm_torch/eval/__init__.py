"""Evaluation helpers of the PyTorch port."""

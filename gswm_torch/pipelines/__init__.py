"""Pipelines of the PyTorch port."""

from gswm_torch.pipelines.inversable import InversablePipeline  # noqa: F401

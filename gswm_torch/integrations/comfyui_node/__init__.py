"""ComfyUI drop-in for the PyTorch port: copy this directory into
ComfyUI/custom_nodes/ (the role of the reference's ComfyUI_GSWaterMark
package; beside the JAX pack's ``comfyui_gswm``, whose node keys these do not
reuse).  Requires ``gswm_torch`` importable in ComfyUI's Python environment;
the node embeds on the card.  An example graph is
``example_workflows/GS_insert_gswm_torch.json``."""

from gswm_torch.integrations.comfyui import (  # noqa: F401
    NODE_CLASS_MAPPINGS,
    NODE_DISPLAY_NAME_MAPPINGS,
)

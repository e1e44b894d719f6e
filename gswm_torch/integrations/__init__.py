"""Host-app integration surfaces of the PyTorch port, shaped like the
reference's front-ends (the port of ``gswm.integrations``):

  comfyui.py    — GSLatent + GSKSamplerAdvanced node pair (nodes.py parity),
                  under node keys of their own (``*_torch``), so both packs
                  can be installed side by side
  a1111.py      — A1111-script-shaped shim (scripts/GS_watermark_insert_*
                  parity)
  comfyui_node/ — the directory to copy into ComfyUI/custom_nodes, with an
                  example workflow
  scripts/      — the files to copy into stable-diffusion-webui/scripts

Both embed with the port's ``embed_latents`` on a torch device (the card by
default: K3 makes the keystream) and load without their host: ComfyUI's and
the WebUI's modules are imported only where a host calls in.
"""

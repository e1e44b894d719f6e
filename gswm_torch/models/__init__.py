"""Models of the PyTorch port: UNet2DCondition, the VAE encoder, the CLIP
text encoder, the presets, and the bridge from the JAX package's weights."""

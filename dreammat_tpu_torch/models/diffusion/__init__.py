"""Diffusion models (UNet, ControlNet, VAE, CLIP) and the weight bridge."""

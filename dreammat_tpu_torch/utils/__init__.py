"""Tensor helpers, config, device probes."""

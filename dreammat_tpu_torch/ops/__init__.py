"""Ops: the CUDA kernels with their plain versions, and the tensor code around them."""

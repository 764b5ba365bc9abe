"""Tensor operations below both the layers (nn/) and the kernels
(kernels/): plain functions on tensors that import neither."""

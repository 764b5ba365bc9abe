"""biasgan_tpu_torch — the PyTorch / CUDA port of biasgan_tpu for NVIDIA
Hopper (H100), beside the JAX package it is held against.

The module layout mirrors ``biasgan_tpu`` so each counterpart is easy to
find:
  nn/        -- layers and the ResNet generator (NHWC activations, torch
                OIHW / IOHW weights, so reference ``.pth`` files load as is)
  kernels/   -- hand-written CUDA kernels for sm_90a, built with nvcc and
                bound with ctypes, each beside its plain PyTorch version
  data/      -- numpy-only climate ingestion, stats, loader
  utils/     -- ``<epoch>_net_<name>.pth`` checkpoints
  convert.py -- JAX parameter trees <-> port state_dicts
  config.py  -- dataclass config with per-model/dataset flag injection
  infer.py   -- full-field inference CLI (``python -m
                biasgan_tpu_torch.infer``)

The package imports torch and never jax.
"""

__version__ = "0.1.0"

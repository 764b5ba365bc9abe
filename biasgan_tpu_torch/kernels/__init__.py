"""Hand-written CUDA kernels of the port (sm_90a), each with its plain
PyTorch version beside it. Sources live in ``csrc/``; ``build.py`` compiles
them with nvcc on first use and loads them with ctypes."""

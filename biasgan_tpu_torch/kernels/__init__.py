"""Hand-written CUDA kernels of the port (sm_90a), each with its plain
PyTorch version beside it. Sources live in ``csrc/``; ``build.py`` compiles
them with nvcc on first use and loads them with ctypes."""


def wrappers() -> dict:
    """Each kernel's wrapper, by name, from ``build.SOURCES``."""
    import importlib

    from biasgan_tpu_torch.kernels.build import SOURCES

    return {
        wrapper: getattr(importlib.import_module(f"{__name__}.{module}"), wrapper)
        for module, wrapper in SOURCES.values()
    }


def launch_counts() -> dict:
    """Each kernel wrapper's launches in this process so far, by name."""
    return {name: fn.launches for name, fn in wrappers().items()}

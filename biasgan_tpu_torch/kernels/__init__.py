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


def counters() -> dict:
    """Every launch count of the kernel wrappers, name -> (wrapper,
    attribute): each wrapper's ``launches``, and where a wrapper routes bf16
    to a TMA / wgmma kernel, those launches as ``<name>.wgmma_launches``."""
    out = {}
    for name, fn in wrappers().items():
        out[name] = (fn, "launches")
        if hasattr(fn, "wgmma_launches"):
            out[f"{name}.wgmma_launches"] = (fn, "wgmma_launches")
    return out


def launch_counts() -> dict:
    """Each count of ``counters()`` in this process so far, by name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def zero_counts() -> None:
    """Set every count of ``counters()`` to 0."""
    for fn, attr in counters().values():
        setattr(fn, attr, 0)

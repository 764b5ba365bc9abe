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


# the launches a wrapper counts per path, where it has paths: bf16 to a TMA
# / wgmma kernel (K1, K3, K4, K5, K6); the instance norm's cluster and
# persistent paths (K7)
PATH_COUNTS = ("wgmma_launches", "cluster_launches", "persistent_launches")


def counters() -> dict:
    """Every launch count of the kernel wrappers, name -> (wrapper,
    attribute): each wrapper's ``launches``, and those on each of its
    paths as ``<name>.<attribute>`` (PATH_COUNTS)."""
    out = {}
    for name, fn in wrappers().items():
        out[name] = (fn, "launches")
        for attr in PATH_COUNTS:
            if hasattr(fn, attr):
                out[f"{name}.{attr}"] = (fn, attr)
    return out


def launch_counts() -> dict:
    """Each count of ``counters()`` in this process so far, by name."""
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def zero_counts() -> None:
    """Set every count of ``counters()`` to 0."""
    for fn, attr in counters().values():
        setattr(fn, attr, 0)

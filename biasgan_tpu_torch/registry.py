"""Name-keyed plugin registries for models and datasets.

Counterpart of ``biasgan_tpu/registry.py``: a string key selects the
implementation AND injects its extra config fields into the CLI (the
reference family's ``modify_commandline_options``), through the two-phase
parse in config.py.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

_MODELS: Dict[str, type] = {}
_MODEL_CONFIGS: Dict[str, type] = {}
_DATASETS: Dict[str, type] = {}
_DATASET_CONFIGS: Dict[str, type] = {}


def register_model(name: str, config_cls: Optional[type] = None) -> Callable:
    def deco(cls: type) -> type:
        _MODELS[name] = cls
        if config_cls is not None:
            _MODEL_CONFIGS[name] = config_cls
        return cls

    return deco


def register_dataset(name: str, config_cls: Optional[type] = None) -> Callable:
    def deco(cls: type) -> type:
        _DATASETS[name] = cls
        if config_cls is not None:
            _DATASET_CONFIGS[name] = config_cls
        return cls

    return deco


def _ensure_builtin_imports() -> None:
    # Import side-effect registration of the built-in zoo.
    import biasgan_tpu_torch.models  # noqa: F401
    import biasgan_tpu_torch.data  # noqa: F401


def get_model(name: str) -> type:
    _ensure_builtin_imports()
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(_MODELS)}")
    return _MODELS[name]


def get_model_config(name: str) -> Optional[type]:
    _ensure_builtin_imports()
    return _MODEL_CONFIGS.get(name)


def get_dataset(name: str) -> type:
    _ensure_builtin_imports()
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(_DATASETS)}")
    return _DATASETS[name]


def get_dataset_config(name: str) -> Optional[type]:
    _ensure_builtin_imports()
    return _DATASET_CONFIGS.get(name)


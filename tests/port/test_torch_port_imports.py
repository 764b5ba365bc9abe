"""The port imports neither JAX nor the JAX package: every module of
biasgan_tpu_torch (the kernel wrappers included) imports in a fresh
interpreter without pulling in ``jax`` or ``biasgan_tpu``, so the port runs
on a GPU host that has no JAX."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
import importlib, pkgutil, sys
import biasgan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(biasgan_tpu_torch.__path__, "biasgan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "biasgan_tpu"))
print(len(names), bad)
"""


def test_port_modules_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout.split(maxsplit=1)
    n_modules, bad = int(out[0]), out[1].strip()
    assert n_modules >= 20  # every module was walked, kernels included
    assert bad == "[]", bad

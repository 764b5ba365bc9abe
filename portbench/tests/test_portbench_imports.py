"""What the bench loads: no module whose top-level name is jax, jaxlib,
flax or biasgan_tpu (compared whole: biasgan_tpu_torch is the program),
the reference nothing of the program; and a run without a CUDA device
exits non-zero with no result."""

import ast
import glob
import os
import subprocess
import sys
import types

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import SERVE

REPO = os.path.dirname(harness.ROOT)


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(harness.ROOT, "**", "*.py"),
                                               recursive=True)))
def test_no_forbidden_import(path):
    tops = set(imported_tops(path))
    assert not tops & set(harness.FORBIDDEN_MODULES)
    if os.sep + "reference" + os.sep in path:
        assert "biasgan_tpu_torch" not in tops


def test_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "biasgan_tpu_torch_extra", types.ModuleType("x"))
    assert "biasgan_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("x"))
    assert "flax" in harness.forbidden_modules()


def test_loaded_modules_after_a_run():
    """A tiny run of every kind in a fresh process loads none of them."""
    code = (
        "import sys; from portbench.tests import tiny; from portbench.tests.tiny import run, tiny_cell\n"
        "from portbench import harness\n"
        "for c in (tiny.SERVE, tiny.CYCLE):\n"
        "    run(tiny_cell(c), trace=True)\n"
        "harness.metric_readers()\n"
        "print('FOUND', harness.forbidden_modules())\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", SERVE,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout

"""``python -m biasgan_tpu_torch.dryrun 2 --device cpu``: the port's
multi-rank dry run (the counterpart of ``__graft_entry__.dryrun_multichip``)
passes its eight stages on two gloo ranks at tiny shapes, prints a line per
stage and ends in ``all 8 stages OK``, with exit code 0; a ``jax`` package
that refuses to import, first on the path of the run and of its spawned
ranks, shows that nothing of it imports JAX."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_dryrun_two_ranks_passes_every_stage(tmp_path):
    fake = tmp_path / "jax"
    fake.mkdir()
    (fake / "__init__.py").write_text("raise ImportError('the dry run imported jax')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]),
               OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-m", "biasgan_tpu_torch.dryrun", "2", "--device",
                        "cpu"], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    lines = p.stdout.splitlines()
    stages = [ln for ln in lines if ln.startswith("[dryrun] stage ")]
    assert [ln.split()[2] for ln in stages] == ["1/8:", "2/8:", "3/8:", "3b/8:", "4/8:",
                                               "5/8:", "6/8:", "7/8:", "8/8:"]
    assert lines[-1].startswith("[dryrun] all 8 stages OK")

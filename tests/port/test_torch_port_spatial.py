"""The spatially sharded generator forward of the port
(biasgan_tpu_torch/parallel/spatial.py) against the whole field and the JAX
package: resnet_3blocks, ngf 8, with the JAX weights converted, over 2 and
4 spawned gloo ranks (one spawn per rank count carries its cases), periodic
('wrap') and zero-edge W, through the plain halo ring or the
``halo_exchange_w`` wrapper, and with ``--fused_blocks`` (the block conv's
halo W mode with moments summed over the shards).

Each sharded output is held, at rtol 1e-4 / atol 1e-5
(tests/distributed/test_spatial.py), to the port's unfused whole-field
forward and to the JAX ``spatial_apply`` on the same number of devices of
the conftest's virtual mesh (the JAX fused blocks in Pallas interpret
mode). The fused cases are those of tests/distributed/test_fused_spatial.py
with sizes as there: local block width 8. Last, the spawn runner raises
what a failing rank raised and kills ranks that outlive its join timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.nn.generators import ResNetGenerator
from biasgan_tpu.parallel import make_mesh
from biasgan_tpu.parallel import spatial_apply as jax_spatial_apply
from biasgan_tpu_torch.convert import params_to_state_dict
from biasgan_tpu_torch.nn import define_G
from biasgan_tpu_torch.parallel import spawn
from biasgan_tpu_torch.parallel.checks import generator_cases

RTOL, ATOL = 1e-4, 1e-5
SPAWN_TIMEOUT_S = 300
H = 16
SPEC = dict(netG="resnet_3blocks", input_nc=1, output_nc=1, ngf=8, norm="instance",
            out_activation="none")
# rank count -> cases; each field's W makes the local block width 8
CASES = {
    2: [dict(w_mode="wrap", fused=False, rdma=False),
        dict(w_mode="zero", fused=False, rdma=True),
        dict(w_mode="zero", fused=True, rdma=False)],
    4: [dict(w_mode="wrap", fused=False, rdma=True),
        dict(w_mode="zero", fused=False, rdma=False),
        dict(w_mode="wrap", fused=True, rdma=True)],
}


def _field(n):
    return np.random.default_rng(n).normal(size=(1, H, 32 * n, 1)).astype(np.float32)


def _jax_params(n):
    g = ResNetGenerator(output_nc=1, ngf=8, n_blocks=3, norm_type="instance",
                        w_mode="wrap", out_activation="none")
    return g.init(jax.random.PRNGKey(n), jnp.asarray(_field(n)))


def _state(n):
    v = _jax_params(n)
    return {k: t.numpy() for k, t in params_to_state_dict(v["params"]).items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request):
    n = request.param
    res = spawn(generator_cases, n, (SPEC, _state(n), _field(n), CASES[n]),
                timeout=SPAWN_TIMEOUT_S, group_timeout=SPAWN_TIMEOUT_S)
    return n, res


def _whole_field(n, w_mode):
    G = define_G(**SPEC, w_mode=w_mode)
    G.load_state_dict({k: torch.from_numpy(v) for k, v in _state(n).items()})
    with torch.inference_mode():
        return G.eval()(torch.from_numpy(_field(n))).numpy()


def _jax_sharded(n, w_mode, fused, monkeypatch):
    if fused:
        monkeypatch.setenv("BIASGAN_FUSED_BLOCK", "interpret")
        monkeypatch.setenv("BIASGAN_FUSED_MIN_C", "1")
    g = ResNetGenerator(output_nc=1, ngf=8, n_blocks=3, norm_type="instance",
                        w_mode=w_mode, out_activation="none")
    fwd = jax.jit(jax_spatial_apply(g, make_mesh(data=1, spatial=n), train=False,
                                    periodic=w_mode == "wrap"))
    return np.asarray(fwd(_jax_params(n), jnp.asarray(_field(n))))


@pytest.mark.parametrize("case", range(3))
def test_sharded_forward_matches_whole_field_and_jax(sharded, case, monkeypatch):
    n, res = sharded
    c = CASES[n][case]
    got = res["outputs"][case]
    assert got.shape == (1, H, 32 * n, 1)
    np.testing.assert_allclose(got, _whole_field(n, c["w_mode"]), rtol=RTOL, atol=ATOL)
    want = _jax_sharded(n, c["w_mode"], c["fused"], monkeypatch)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sharded_ranks_launch_no_kernel_on_the_cpu(sharded):
    """On CPU tensors every wrapper takes its plain version."""
    n, res = sharded
    assert len(res["launches"]) == n
    assert all(v == 0 for counts in res["launches"] for v in counts.values())


def test_spawn_raises_what_a_rank_raises_and_times_out():
    """No rank failure is swallowed: a field that does not split over the
    ranks fails every rank, and the parent raises with the rank's error;
    ranks that outlive the join timeout are killed and the parent raises."""
    from torch.multiprocessing import ProcessRaisedException

    x = np.zeros((1, 2, 7, 1), np.float32)  # 7 columns do not split over 2 ranks
    with pytest.raises(ProcessRaisedException, match="does not split into 2 shards"):
        spawn(generator_cases, 2, (SPEC, _state(2), x, CASES[2][:1]),
              timeout=SPAWN_TIMEOUT_S, group_timeout=SPAWN_TIMEOUT_S)
    with pytest.raises(TimeoutError, match="still running after 0.5 s"):
        spawn(generator_cases, 2, (SPEC, _state(2), _field(2), CASES[2][:1]),
              timeout=0.5, group_timeout=SPAWN_TIMEOUT_S)

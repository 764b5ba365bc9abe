"""The hand-written CUDA kernels of the port on the card, against their
plain PyTorch versions on the same inputs (TF32 off). These tests need an
NVIDIA GPU and skip without one; they import neither JAX nor the JAX
package, so a GPU host without JAX runs them with

    python -m pytest --noconftest -m cuda tests/port/test_torch_port_cuda.py

Tolerances: |y - ref| <= tol * (1 + |ref|) with tol 1e-4 (f32) / 2e-2
(bf16); moments 1e-3 relative, and no further from the plain version's
than the stored outputs are, plus 1e-5 of f32 summation order (the moments
are those of the stored value).
"""

import numpy as np
import pytest
import torch

from biasgan_tpu_torch.kernels.conv3x3_fused import (
    conv3x3_fused,
    conv3x3_fused_plain,
)
from biasgan_tpu_torch.kernels.conv3x3s2_fused import (
    conv3x3s2_fused,
    conv3x3s2_fused_plain,
)
from biasgan_tpu_torch.kernels.conv7x7 import conv7x7, conv7x7_plain
from biasgan_tpu_torch.kernels.convt3x3s2_fused import (
    convt3x3s2_fused,
    convt3x3s2_fused_plain,
)
from biasgan_tpu_torch.kernels.instance_norm_act import (
    instance_norm_act,
    instance_norm_act_plain,
)

PAD_PAIRS = [(h, w) for h in ("reflect", "zero", "wrap") for w in ("wrap", "zero", "reflect")]


def _inputs(n, h, w, c, cout, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(cout, c, 3, 3)) / (9 * c) ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
    a = torch.from_numpy((rng.random((n, c)) + 0.5).astype(np.float32))
    pb = torch.from_numpy((rng.normal(size=(n, c)) * 0.5).astype(np.float32))
    return [t.cuda() for t in (x.to(dtype), k.to(dtype), b, a, pb)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU form)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _check_y(y, ry, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    yf, rf = y.float(), ry.float()
    assert y.dtype == ry.dtype and y.shape == ry.shape
    assert bool(((yf - rf).abs() <= tol * (1 + rf.abs())).all())


def _check_moments(y, ry, m, rm):
    """Within 1e-3 relative (the sum against sqrt(H W sumsq)), and, as
    moments of the stored value, no further off than the stored y is, plus
    1e-5 of f32 summation order."""
    (s, q), (rs, rq) = m, rm
    scale = (y.shape[1] * y.shape[2] * rq).sqrt()
    assert float(((s - rs).abs() / scale).max()) <= 1e-3
    assert float(((q - rq).abs() / rq).max()) <= 1e-3
    yf, rf = y.float(), ry.float()
    dims = (1, 2)
    assert bool(((s - rs).abs() <= (yf - rf).abs().sum(dims)
                 + 1e-5 * rf.abs().sum(dims)).all())
    assert bool(((q - rq).abs() <= (yf.square() - rf.square()).abs().sum(dims)
                 + 1e-5 * rf.square().sum(dims)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(3, 5), (32, 48), (256, 256)])
def test_conv3x3_fused_kernel_matches_plain(dtype, c, cout):
    """Odd shapes (prime H, W not a multiple of the tile), every pad pair,
    with and without the prologue."""
    _needs_card()
    for i, (h_mode, w_mode) in enumerate(PAD_PAIRS):
        x, k, b, a, pb = _inputs(2, 13, 37, c, cout, dtype, seed=i)
        pro = (a, pb) if i % 2 else None
        args = (x, k, b, pro, "relu", h_mode, w_mode, True)
        before = conv3x3_fused.launches
        y, m = conv3x3_fused(*args)
        assert conv3x3_fused.launches == before + 1
        ry, rm = conv3x3_fused_plain(*args)
        _check_y(y, ry, dtype)
        _check_moments(y, ry, m, rm)


@pytest.mark.cuda
def test_conv3x3_fused_kernel_refuses_bad_input():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU form)")
    x, k, b, _, _ = _inputs(1, 8, 16, 8, 8, torch.float32, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        conv3x3_fused(x.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_fused(x.permute(0, 2, 1, 3), k)
    with pytest.raises(ValueError, match="tensor on cpu"):
        conv3x3_fused(x, k.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(3, 5), (64, 128), (128, 256), (256, 64)])
@pytest.mark.parametrize("which", ["down", "up"])
def test_updown_kernels_match_plain(which, dtype, c, cout):
    """Ragged tiles (output H 13 or input H 13), both W modes, with and
    without the prologue."""
    _needs_card()
    fn, plain = ((conv3x3s2_fused, conv3x3s2_fused_plain) if which == "down"
                 else (convt3x3s2_fused, convt3x3s2_fused_plain))
    for i, w_mode in enumerate(("wrap", "zero", "wrap", "zero")):
        h, w = (26, 38) if which == "down" else (13, 19)
        x, k, b, a, pb = _inputs(2, h, w, c, cout, dtype, seed=10 + i)
        if which == "up":
            k = k.transpose(0, 1).contiguous()  # IOHW
        args = (x, k, b, (a, pb) if i >= 2 else None, "relu", w_mode, True)
        before = fn.launches
        y, m = fn(*args)
        assert fn.launches == before + 1
        ry, rm = plain(*args)
        _check_y(y, ry, dtype)
        _check_moments(y, ry, m, rm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(3, 64), (1, 5), (8, 8), (64, 3), (24, 1), (9, 8)])
def test_conv7x7_kernel_matches_plain(dtype, cin, cout):
    _needs_card()
    rng = np.random.default_rng(cin * 10 + cout)
    xp = torch.from_numpy(rng.normal(size=(2, 19, 41, cin)).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(cout, cin, 7, 7)) / (49 * cin) ** 0.5)
                         .astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
    xp, k, b = xp.to(dtype).cuda(), k.to(dtype).cuda(), b.cuda()
    before = conv7x7.launches
    y = conv7x7(xp, k, b)
    assert conv7x7.launches == before + 1
    _check_y(y, conv7x7_plain(xp, k, b), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [5, 64, 256, 264])
def test_instance_norm_act_kernel_matches_plain(dtype, c):
    _needs_card()
    for i, (act, res) in enumerate((("relu", False), ("none", True), ("lrelu", True))):
        rng = np.random.default_rng(c + i)
        x = torch.from_numpy((rng.normal(size=(2, 13, 37, c)) * 3 + 1).astype(np.float32))
        r = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)) if res else None
        x = x.to(dtype).cuda()
        r = None if r is None else r.to(dtype).cuda()
        before = instance_norm_act.launches
        y = instance_norm_act(x, r, act)
        assert instance_norm_act.launches == before + 1
        _check_y(y, instance_norm_act_plain(x, r, act), dtype)

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

PAD_PAIRS = [(h, w) for h in ("reflect", "zero", "wrap") for w in ("wrap", "zero", "reflect")]


def _inputs(n, h, w, c, cout, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, h, w, c)).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(cout, c, 3, 3)) / (9 * c) ** 0.5).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
    a = torch.from_numpy((rng.random((n, c)) + 0.5).astype(np.float32))
    pb = torch.from_numpy((rng.normal(size=(n, c)) * 0.5).astype(np.float32))
    return [t.cuda() for t in (x.to(dtype), k.to(dtype), b, a, pb)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(3, 5), (32, 48), (256, 256)])
def test_conv3x3_fused_kernel_matches_plain(dtype, c, cout):
    """Odd shapes (prime H, W not a multiple of the tile), every pad pair,
    with and without the prologue."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU form)")
    torch.backends.cudnn.allow_tf32 = False
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for i, (h_mode, w_mode) in enumerate(PAD_PAIRS):
        x, k, b, a, pb = _inputs(2, 13, 37, c, cout, dtype, seed=i)
        pro = (a, pb) if i % 2 else None
        args = (x, k, b, pro, "relu", h_mode, w_mode, True)
        before = conv3x3_fused.launches
        y, (s, q) = conv3x3_fused(*args)
        assert conv3x3_fused.launches == before + 1
        ry, (rs, rq) = conv3x3_fused_plain(*args)
        yf, rf = y.float(), ry.float()
        assert bool(((yf - rf).abs() <= tol * (1 + rf.abs())).all()), (h_mode, w_mode)
        scale = (13 * 37 * rq).sqrt()
        assert float(((s - rs).abs() / scale).max()) <= 1e-3
        assert float(((q - rq).abs() / rq).max()) <= 1e-3
        # moments of the stored value: no further off than the stored y is
        dims = (1, 2)
        assert bool(((s - rs).abs() <= (yf - rf).abs().sum(dims)
                     + 1e-5 * rf.abs().sum(dims)).all())
        assert bool(((q - rq).abs() <= (yf.square() - rf.square()).abs().sum(dims)
                     + 1e-5 * rf.square().sum(dims)).all())


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

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 9, 12, 20), (1, 7, 18, 64, 136)])
def test_conv3x3_fused_tiles_touching_every_edge(dtype, shape):
    """Tiles of the bf16 kernel (7 x 18 pixels) touching both edges at once
    (both pad rows and columns, the four corners) in every h_mode x w_mode
    pair, the halo mode included, with and without the prologue; C 12 and
    Cout 20 padded by the wrapper, Cout 136 in two 128-cout tiles. Every
    bf16 call takes the TMA / wgmma kernel (``wgmma_launches`` moves by
    one), every f32 call the CUDA-core one (it does not move)."""
    _needs_card()
    n, h, w, c, cout = shape
    i = 0
    for h_mode in ("reflect", "zero", "wrap"):
        for w_mode in ("wrap", "zero", "reflect", "halo"):
            for pro_on in (False, True):
                x, k, b, a, pb = _inputs(n, h, w + 2 * (w_mode == "halo"), c, cout, dtype, i)
                i += 1
                args = (x, k, b, (a, pb) if pro_on else None, "relu", h_mode, w_mode, True)
                before = (conv3x3_fused.launches, conv3x3_fused.wgmma_launches)
                y, m = conv3x3_fused(*args)
                assert (conv3x3_fused.launches, conv3x3_fused.wgmma_launches) == (
                    before[0] + 1, before[1] + (dtype == torch.bfloat16))
                ry, rm = conv3x3_fused_plain(*args)
                assert tuple(y.shape) == (n, h, w, cout)
                _check_y(y, ry, dtype)
                _check_moments(y, ry, m, rm)


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(64, 128), (256, 256)])
def test_conv3x3_fused_batch_walks_across_images(c, cout):
    """Batch 2 with 117 tiles per image, more than the card's SMs: blocks
    of the bf16 kernel's persistent grid walk from one image into the next
    (a and b and the moment slots change image), 128- and 256-cout tiles,
    in three pad mode pairs, with and without the prologue."""
    _needs_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 2 * 13 * 9 > sms  # (90, 150): 13 x 9 tiles of 7 x 18 per image
    for i, (h_mode, w_mode) in enumerate((("reflect", "wrap"), ("zero", "halo"),
                                          ("wrap", "reflect"))):
        halo = w_mode == "halo"
        x, k, b, a, pb = _inputs(2, 90, 150 + 2 * halo, c, cout, torch.bfloat16, 20 + i)
        args = (x, k, b, (a, pb) if i != 1 else None, "relu", h_mode, w_mode, True)
        before = conv3x3_fused.wgmma_launches
        y, m = conv3x3_fused(*args)
        assert conv3x3_fused.wgmma_launches == before + 1
        ry, rm = conv3x3_fused_plain(*args)
        _check_y(y, ry, torch.bfloat16)
        _check_moments(y, ry, m, rm)


@pytest.mark.cuda
def test_conv3x3_fused_bf16_kernel_refuses_misaligned_input():
    """The bf16 kernel loads x with TMA: an x whose address is not 16-byte
    aligned raises and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU form)")
    x, k, b, _, _ = _inputs(1, 8, 16, 64, 64, torch.bfloat16, 0)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    shifted = shifted.view(x.shape).copy_(x)  # contiguous, 2 bytes off
    before = (conv3x3_fused.launches, conv3x3_fused.wgmma_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv3x3_fused(shifted, k, b)
    assert (conv3x3_fused.launches, conv3x3_fused.wgmma_launches) == before


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
    without the prologue. The down conv also over several tiles of its bf16
    kernel (128 pixels of one pair row), the last of each row ragged
    (output 13 x 300), at batch 2 and 1, and at batch 2 with more tiles
    than the card has SMs (output 45 x 300), so that blocks of the
    persistent grid walk from one image into the next (the prologue's a and
    b and the moment slots change image mid-walk); every bf16 call of
    either on its TMA / wgmma path, every f32 call off it."""
    _needs_card()
    fn, plain = ((conv3x3s2_fused, conv3x3s2_fused_plain) if which == "down"
                 else (convt3x3s2_fused, convt3x3s2_fused_plain))
    sizes = [(2, 26, 38) if which == "down" else (2, 13, 19)]
    if which == "down" and (c, cout) in ((64, 128), (128, 256)):
        sizes += [(2, 26, 600), (1, 26, 600), (2, 90, 600)]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert 2 * 45 * 3 > sms  # (2, 90, 600): 135 tiles per image
    for n, h, w in sizes:
        for i, w_mode in enumerate(("wrap", "zero", "wrap", "zero")):
            x, k, b, a, pb = _inputs(n, h, w, c, cout, dtype, seed=10 + i)
            if which == "up":
                k = k.transpose(0, 1).contiguous()  # IOHW
            args = (x, k, b, (a, pb) if i >= 2 else None, "relu", w_mode, True)
            before = (fn.launches, fn.wgmma_launches)
            y, m = fn(*args)
            assert (fn.launches, fn.wgmma_launches) == (
                before[0] + 1, before[1] + (dtype == torch.bfloat16))
            ry, rm = plain(*args)
            _check_y(y, ry, dtype)
            _check_moments(y, ry, m, rm)


@pytest.mark.cuda
def test_down_kernel_refuses_strided_or_misaligned_input():
    """The bf16 kernel loads x with TMA: a non-contiguous x, or one whose
    address is not 16-byte aligned, raises and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU form)")
    x, k, b, _, _ = _inputs(1, 8, 16, 64, 128, torch.bfloat16, 0)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    shifted = shifted.view(x.shape).copy_(x)  # contiguous, 2 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = (conv3x3s2_fused.launches, conv3x3s2_fused.wgmma_launches)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3s2_fused(x.transpose(1, 2), k.transpose(2, 3), b)
    with pytest.raises(ValueError, match="16-byte aligned"):
        conv3x3s2_fused(shifted, k, b)
    assert (conv3x3s2_fused.launches, conv3x3s2_fused.wgmma_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 9, 12, 20), (1, 13, 40, 64, 136),
                                   (2, 9, 16, 128, 64), (1, 7, 18, 256, 64)])
def test_convt3x3s2_fused_tiles_touching_every_edge(dtype, shape):
    """Tiles of the bf16 kernel (7 x 18 input pixels) touching all four
    edges at once (the bottom H pad row and the right column, wrapped or
    zero, on every tile), with and without the prologue: C 12 and Cout 20
    padded by the wrapper; three cout blocks, the last ragged (Cout 136),
    over ragged tiles; W narrower than a tile with two channel blocks; one
    tile filled exactly (7 x 18, four channel blocks). Every bf16 call takes
    the TMA / wgmma kernel (``wgmma_launches`` moves by one), every f32
    call the CUDA-core one (it does not move)."""
    _needs_card()
    n, h, w, c, cout = shape
    for i, (w_mode, pro_on) in enumerate((("wrap", False), ("wrap", True), ("zero", False),
                                          ("zero", True))):
        x, k, b, a, pb = _inputs(n, h, w, c, cout, dtype, 30 + i)
        k = k.transpose(0, 1).contiguous()  # IOHW
        args = (x, k, b, (a, pb) if pro_on else None, "relu", w_mode, True)
        before = (convt3x3s2_fused.launches, convt3x3s2_fused.wgmma_launches)
        y, m = convt3x3s2_fused(*args)
        assert (convt3x3s2_fused.launches, convt3x3s2_fused.wgmma_launches) == (
            before[0] + 1, before[1] + (dtype == torch.bfloat16))
        ry, rm = convt3x3s2_fused_plain(*args)
        assert tuple(y.shape) == (n, 2 * h, 2 * w, cout)
        _check_y(y, ry, dtype)
        _check_moments(y, ry, m, rm)


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(64, 128), (128, 64)])
def test_convt3x3s2_fused_batch_walks_across_images(c, cout):
    """Batch 2 with 221 tiles per image (input 90 x 300), more units than
    the card's SMs: blocks of the bf16 kernel's persistent grid walk from
    one image into the next (a and b and the moment slots change image),
    with one or two cout blocks a tile, both W modes, with and without the
    prologue."""
    _needs_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 2 * 13 * 17 > sms  # (90, 300): 13 x 17 tiles of 7 x 18 per image
    for i, (w_mode, pro_on) in enumerate((("wrap", True), ("zero", False))):
        x, k, b, a, pb = _inputs(2, 90, 300, c, cout, torch.bfloat16, 40 + i)
        k = k.transpose(0, 1).contiguous()  # IOHW
        args = (x, k, b, (a, pb) if pro_on else None, "relu", w_mode, True)
        before = convt3x3s2_fused.wgmma_launches
        y, m = convt3x3s2_fused(*args)
        assert convt3x3s2_fused.wgmma_launches == before + 1
        ry, rm = convt3x3s2_fused_plain(*args)
        _check_y(y, ry, torch.bfloat16)
        _check_moments(y, ry, m, rm)


@pytest.mark.cuda
def test_convt3x3s2_fused_bf16_kernel_refuses_misaligned_input():
    """The bf16 kernel loads x with TMA: an x whose address is not 16-byte
    aligned raises and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU form)")
    x, k, b, _, _ = _inputs(1, 8, 16, 64, 64, torch.bfloat16, 0)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    shifted = shifted.view(x.shape).copy_(x)  # contiguous, 2 bytes off
    before = (convt3x3s2_fused.launches, convt3x3s2_fused.wgmma_launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        convt3x3s2_fused(shifted, k.transpose(0, 1).contiguous(), b)
    assert (convt3x3s2_fused.launches, convt3x3s2_fused.wgmma_launches) == before


def _conv7_inputs(n, hp, wp, cin, cout, dtype, seed):
    rng = np.random.default_rng(seed)
    xp = torch.from_numpy(rng.normal(size=(n, hp, wp, cin)).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(cout, cin, 7, 7)) / (49 * cin) ** 0.5)
                         .astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(cout,)) * 0.1).astype(np.float32))
    return xp.to(dtype).cuda(), k.to(dtype).cuda(), b.cuda()


# the sides of tests/port/test_torch_port_conv7_tiles.py besides the older
# ones: the stem's Cin 1, 3, 8 with Cout 5, 64, 136 (three 64-cout launches,
# the last ragged); the head's Cout 1, 3, 8 with C 9 (padded to 16), 64, 72
# (two channel blocks)
CONV7_SIDES = sorted({(3, 64), (1, 5), (8, 8), (64, 3), (24, 1), (9, 8)}
                     | {(cin, cout) for cin in (1, 3, 8) for cout in (5, 64, 136)}
                     | {(cin, cout) for cout in (1, 3, 8) for cin in (9, 64, 72)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", CONV7_SIDES)
def test_conv7x7_kernel_matches_plain(dtype, cin, cout):
    """Odd shapes, and the bf16 kernels' edges: one 8 x 64 stem tile or
    64-column head unit touching all four edges of a 5 x 9 output, 2 x 2
    ragged stem tiles or two head strips of a 13 x 70 one. Every bf16 call
    on the tensor-core kernel (``wgmma_launches`` moves by one), every f32
    call on the CUDA-core one."""
    _needs_card()
    for n, hp, wp in ((2, 19, 41), (2, 11, 15), (1, 19, 76)):
        xp, k, b = _conv7_inputs(n, hp, wp, cin, cout, dtype, seed=cin * 100 + cout + hp)
        before = (conv7x7.launches, conv7x7.wgmma_launches)
        y = conv7x7(xp, k, b)
        assert (conv7x7.launches, conv7x7.wgmma_launches) == (
            before[0] + 1, before[1] + (dtype == torch.bfloat16))
        _check_y(y, conv7x7_plain(xp, k, b), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 96, 606, 3, 64), (2, 7, 12806, 64, 3),
                                   (3, 262, 262, 3, 64), (3, 262, 262, 64, 3)])
def test_conv7x7_walks_across_images(shape):
    """bf16, batch > 1: 240 stem tiles, more than the card's SMs; head units
    of one row in two rounds of the grid's warpgroups (a walk crossing into
    the next image); the training step's batch-3 stem and head. The bias
    comes in bf16 (the kernels read it in f32, as the wrapper casts it)."""
    _needs_card()
    xp, k, b = _conv7_inputs(*shape, torch.bfloat16, seed=sum(shape))
    b = b.to(torch.bfloat16)
    before = conv7x7.wgmma_launches
    y = conv7x7(xp, k, b)
    assert conv7x7.wgmma_launches == before + 1
    _check_y(y, conv7x7_plain(xp, k, b), torch.bfloat16)


@pytest.mark.cuda
def test_conv7x7_bf16_head_refuses_what_it_cannot_take():
    """A misaligned x (the head's TMA loads) and a C whose weight would not
    fit the head kernel's shared memory raise before any launch."""
    _needs_card()
    xp, k, b = _conv7_inputs(1, 13, 21, 64, 3, torch.bfloat16, seed=1)
    shifted = torch.empty(xp.numel() + 1, dtype=xp.dtype, device="cuda")[1:].view(xp.shape)
    shifted.copy_(xp)
    before = (conv7x7.launches, conv7x7.wgmma_launches)
    with pytest.raises(ValueError, match="aligned"):
        conv7x7(shifted, k, b)
    xw, kw, bw = _conv7_inputs(1, 13, 21, 264, 3, torch.bfloat16, seed=2)
    with pytest.raises(ValueError, match="too large"):
        conv7x7(xw, kw, bw)
    assert (conv7x7.launches, conv7x7.wgmma_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("persistent", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [5, 64, 256, 264])
def test_instance_norm_act_kernel_matches_plain(dtype, c, persistent):
    """Both one-launch paths (the cluster path, which these planes take,
    and the persistent one forced): y within tolerance of the plain
    version, the statistics of the forward within 1e-3, one launch a call
    on its path's counter, a second call bitwise equal."""
    _needs_card()
    path = "persistent" if persistent else "cluster"
    for i, (act, res) in enumerate((("relu", False), ("none", True), ("lrelu", True))):
        rng = np.random.default_rng(c + i)
        x = torch.from_numpy((rng.normal(size=(2, 13, 37, c)) * 3 + 1).astype(np.float32))
        r = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)) if res else None
        x = x.to(dtype).cuda()
        r = None if r is None else r.to(dtype).cuda()
        assert k7_mod.plan_for(x, persistent).path == path
        before = (instance_norm_act.launches, getattr(instance_norm_act, f"{path}_launches"))
        y = instance_norm_act(x, r, act, persistent=persistent)
        assert (instance_norm_act.launches, getattr(instance_norm_act, f"{path}_launches")) == (
            before[0] + 1, before[1] + 1)
        _check_y(y, instance_norm_act_plain(x, r, act), dtype)
        stats = torch.empty((2, 2, c), device="cuda")
        assert torch.equal(k7_mod._launch(x, r, act, 1e-5, stats, persistent), y)
        mean, inv = instance_norm_stats_plain(x)
        assert bool(((stats[0] - mean).abs() <= 1e-3 * (mean.abs() + 1 / inv)).all())
        assert bool(((stats[1] - inv).abs() <= 1e-3 * inv).all())


# ---------------------------------------------------------------------------
# The VALID 3x3 kernel (K6), the differentiable wrappers, and the rule that
# no wrapper returns a result without a grad_fn where autograd records
# ---------------------------------------------------------------------------

from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused_t  # noqa: E402
from biasgan_tpu_torch.kernels.conv3x3_valid import (  # noqa: E402
    conv3x3_op,
    conv3x3_valid,
    conv3x3_valid_dx,
    conv3x3_valid_dx_plain,
    conv3x3_valid_plain,
)

VALID_EPILOGUES = [(bias, res, act) for bias in (False, True) for res in (False, True)
                   for act in ("none", "relu", "lrelu")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(3, 5), (32, 48), (256, 256)])
def test_conv3x3_valid_kernel_matches_plain(dtype, c, cout):
    """Ragged tiles (output 13 x 37), with and without bias and residual,
    each activation."""
    _needs_card()
    for i, (bias, res, act) in enumerate(((False, False, "none"), (True, False, "relu"),
                                          (True, True, "lrelu"), (False, True, "none"))):
        x, k, b, _, _ = _inputs(2, 15, 39, c, cout, dtype, seed=20 + i)
        r = torch.randn((2, 13, 37, cout), device="cuda").to(dtype) if res else None
        args = (x, k, b if bias else None, r, act)
        before = (conv3x3_valid.launches, conv3x3_valid.wgmma_launches)
        with torch.no_grad():
            y = conv3x3_valid(*args)
        assert (conv3x3_valid.launches, conv3x3_valid.wgmma_launches) == (
            before[0] + 1, before[1] + (dtype == torch.bfloat16))
        _check_y(y, conv3x3_valid_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 9, 12, 20), (1, 7, 18, 64, 136)])
def test_conv3x3_valid_tiles_every_epilogue(dtype, shape):
    """Tiles of the bf16 kernel (7 x 18 pixels) touching both edges of the
    output at once (C 12 and Cout 20 padded by the wrapper) or filling it
    exactly (Cout 136 in two 128-cout tiles), every bias / residual /
    activation combination. Every bf16 call takes the TMA / wgmma kernel
    (``wgmma_launches`` moves by one), every f32 call the CUDA-core one."""
    _needs_card()
    n, h, w, c, cout = shape
    for i, (bias, res, act) in enumerate(VALID_EPILOGUES):
        x, k, b, _, _ = _inputs(n, h + 2, w + 2, c, cout, dtype, seed=50 + i)
        r = torch.randn((n, h, w, cout), device="cuda").to(dtype) if res else None
        args = (x, k, b if bias else None, r, act)
        before = conv3x3_valid.wgmma_launches
        with torch.no_grad():
            y = conv3x3_valid(*args)
        assert conv3x3_valid.wgmma_launches == before + (dtype == torch.bfloat16)
        assert tuple(y.shape) == (n, h, w, cout)
        _check_y(y, conv3x3_valid_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_valid_dx_kernel_matches_plain(dtype):
    """The input gradient kernel (the unpadded cotangent, the pad of 2 by
    the kernel, the taps reversed) against its plain version (pad by 2,
    flipped and transposed weight): one tile touching every edge, ragged
    tiles, padded channels, the training shape; one bwd launch a call."""
    _needs_card()
    for i, (n, h, w, c, cout) in enumerate(((2, 5, 9, 12, 20), (1, 7, 18, 64, 136),
                                            (2, 13, 37, 32, 48), (2, 64, 64, 256, 256))):
        g = _inputs(n, h, w, cout, c, dtype, seed=60 + i)[0]  # (n, h, w, Cout)
        k = _inputs(1, 1, 1, c, cout, dtype, seed=80 + i)[1]  # (Cout, C, 3, 3)
        before = (conv3x3_valid.bwd_launches, conv3x3_valid.wgmma_launches)
        dx = conv3x3_valid_dx(g, k)
        assert (conv3x3_valid.bwd_launches, conv3x3_valid.wgmma_launches) == (
            before[0] + 1, before[1] + (dtype == torch.bfloat16))
        assert tuple(dx.shape) == (n, h + 2, w + 2, c)
        _check_y(dx, conv3x3_valid_dx_plain(g, k), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("c,cout", [(64, 128), (256, 256)])
def test_conv3x3_valid_batch_walks_across_images(c, cout):
    """Batch 2 with 117 tiles per image, more than the card's SMs: blocks
    of the persistent grid walk from one image into the next, the
    residual's TMA loads with them; 128- and 256-cout tiles; and the input
    gradient at the same size."""
    _needs_card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 2 * 13 * 9 > sms  # (90, 150): 13 x 9 tiles of 7 x 18 per image
    x, k, b, _, _ = _inputs(2, 92, 152, c, cout, torch.bfloat16, 70)
    r = torch.randn((2, 90, 150, cout), device="cuda").bfloat16()
    with torch.no_grad():
        for args in ((x, k, b, r, "relu"), (x, k, None, None, "lrelu")):
            _check_y(conv3x3_valid(*args), conv3x3_valid_plain(*args), torch.bfloat16)
    g = torch.randn((2, 90, 150, cout), device="cuda").bfloat16()
    _check_y(conv3x3_valid_dx(g, k), conv3x3_valid_dx_plain(g, k), torch.bfloat16)


@pytest.mark.cuda
def test_conv3x3_valid_bf16_kernel_refuses_misaligned_input():
    """The bf16 kernel loads x and the residual with TMA: either one at an
    address that is not 16-byte aligned raises and launches nothing."""
    _needs_card()
    x, k, b, _, _ = _inputs(1, 10, 18, 64, 64, torch.bfloat16, 0)
    r = torch.randn((1, 8, 16, 64), device="cuda").bfloat16()

    def shifted(t):  # contiguous, 2 bytes off
        s = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
        return s.view(t.shape).copy_(t)

    before = (conv3x3_valid.launches, conv3x3_valid.wgmma_launches)
    with torch.no_grad():
        for args in ((shifted(x), k, b, None), (x, k, b, shifted(r))):
            with pytest.raises(ValueError, match="16-byte aligned"):
                conv3x3_valid(*args)
    assert (conv3x3_valid.launches, conv3x3_valid.wgmma_launches) == before


def _grad_check(fn, plain, inputs, dtype):
    """The Function's grads of a random cotangent against autograd through
    the plain version, on the card (the JAX tests' bounds)."""
    def run(f):
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = f(*ins)
        outs = list(out) if isinstance(out, tuple) else [out]
        outs = [o for t in outs for o in (t if isinstance(t, tuple) else (t,))]
        assert all(o.grad_fn is not None for o in outs)
        g = torch.Generator(device="cuda").manual_seed(3)
        loss = sum((o.float() * torch.randn(o.shape, generator=g, device="cuda")).sum()
                   for o in outs)
        loss.backward()
        return [t.grad.float() for t in ins]

    for got, ref in zip(run(fn), run(plain)):
        scale = max(1.0, float(ref.abs().max()))
        if dtype == torch.float32:
            assert bool(((got - ref).abs() <= 2e-4 * scale + 2e-5 * ref.abs()).all())
        else:
            assert bool(((got - ref).abs() <= 0.05 * scale + 0.1 * ref.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_match_autograd_through_plain(dtype):
    _needs_card()
    x, k, b, a, pb = _inputs(2, 13, 37, 32, 48, dtype, seed=30)
    _grad_check(lambda x, k, b, a, pb: conv3x3_fused_t(x, k, b, (a, pb)),
                lambda x, k, b, a, pb: conv3x3_fused_plain(x, k, b, (a, pb)),
                [x, k, b, a, pb], dtype)
    before = (conv3x3_valid.launches, conv3x3_valid.bwd_launches)
    xp, k2, b2, _, _ = _inputs(2, 15, 39, 32, 48, dtype, seed=31)
    _grad_check(conv3x3_op, conv3x3_valid_plain, [xp, k2, b2], dtype)
    assert (conv3x3_valid.launches, conv3x3_valid.bwd_launches) == (before[0] + 1,
                                                                    before[1] + 1)
    rng = np.random.default_rng(32)
    xp7 = torch.from_numpy(rng.normal(size=(2, 19, 41, 3)).astype(np.float32)).to(dtype).cuda()
    k7 = torch.from_numpy((rng.normal(size=(16, 3, 7, 7)) * 0.1).astype(np.float32)).to(dtype).cuda()
    before = conv7x7.wgmma_launches
    _grad_check(conv7x7, conv7x7_plain, [xp7, k7, torch.zeros(16, device="cuda")], dtype)
    # the head (its forward on the kernel; bf16: the tensor-core one)
    _grad_check(conv7x7, conv7x7_plain, list(_conv7_inputs(2, 38, 46, 64, 3, dtype, 33)), dtype)
    assert conv7x7.wgmma_launches == before + 2 * (dtype == torch.bfloat16)
    xi = torch.randn((2, 13, 37, 64), device="cuda").to(dtype)
    r = torch.randn((2, 13, 37, 64), device="cuda").to(dtype)
    for act in ("relu", "lrelu", "none"):
        _grad_check(lambda x, r: instance_norm_act(x, r, act),
                    lambda x, r: instance_norm_act_plain(x, r, act), [xi, r], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_t_halo_mode_matches_autograd_through_plain(dtype):
    """K2's halo W mode (spatially sharded training): the grads of x, its
    two halo columns included, and of the weight, bias and prologue,
    against autograd through the plain version; each forward launches the
    kernel once."""
    _needs_card()
    for i, (h_mode, pro_on) in enumerate((("reflect", True), ("zero", False))):
        x, k, b, a, pb = _inputs(2, 13, 39, 32, 48, dtype, seed=40 + i)
        before = conv3x3_fused_t.launches
        _grad_check(
            lambda x, k, b, *pro: conv3x3_fused_t(x, k, b, pro or None, "relu", h_mode,
                                                  "halo"),
            lambda x, k, b, *pro: conv3x3_fused_plain(x, k, b, pro or None, "relu", h_mode,
                                                      "halo"),
            [x, k, b, a, pb] if pro_on else [x, k, b], dtype)
        assert conv3x3_fused_t.launches == before + 1


@pytest.mark.cuda
def test_wrappers_never_return_detached_results_on_the_card():
    """Every wrapper on a CUDA input that requires grad: a grad_fn, or (the
    inference-only K4 / K5) an error."""
    _needs_card()
    x, k, b, a, pb = _inputs(1, 8, 16, 8, 8, torch.float32, 0)
    k.requires_grad_(True)
    y, (s, q) = conv3x3_fused(x, k, b, (a, pb))
    assert y.grad_fn is not None and s.grad_fn is not None
    assert conv3x3_valid(x, k).grad_fn is not None
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3_valid(x, k, activation="relu")
    xp7 = torch.randn((1, 14, 14, 3), device="cuda", requires_grad=True)
    assert conv7x7(xp7, torch.randn((8, 3, 7, 7), device="cuda")).grad_fn is not None
    assert instance_norm_act(x.clone().requires_grad_(True)).grad_fn is not None
    with pytest.raises(RuntimeError, match="inference-only"):
        conv3x3s2_fused(x, k)
    with pytest.raises(RuntimeError, match="inference-only"):
        convt3x3s2_fused(x, k.transpose(0, 1))
    with torch.no_grad():
        conv3x3s2_fused(x, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cout", [(3, 5), (32, 48), (256, 256)])
def test_conv3x3_fused_halo_mode_matches_plain(dtype, c, cout):
    """The halo W mode: an input carrying its two W pad columns, every H
    pad, with and without the prologue (which applies to the pad columns
    too)."""
    _needs_card()
    for i, h_mode in enumerate(("reflect", "zero", "wrap")):
        for pro_on in (False, True):
            x, k, b, a, pb = _inputs(2, 13, 39, c, cout, dtype, seed=10 + i)
            args = (x, k, b, (a, pb) if pro_on else None, "relu", h_mode, "halo", True)
            y, m = conv3x3_fused(*args)
            ry, rm = conv3x3_fused_plain(*args)
            assert tuple(y.shape) == (2, 13, 37, cout)
            _check_y(y, ry, dtype)
            _check_moments(y, ry, m, rm)


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [True, False])
def test_halo_exchange_self_ring_on_the_card(periodic):
    """One shard, no process group: the kernel writes into its own receive
    buffers, ordered by its stream alone (no host sync); the halos equal the
    plain version's (wrap or zero) bitwise."""
    _needs_card()
    from biasgan_tpu_torch.kernels.halo_exchange import (
        HaloRing,
        halo_exchange_w,
        halo_exchange_w_plain,
    )

    ring = HaloRing(1, periodic)
    syncs = HaloRing.host_syncs
    for shape, dtype, left, right in (((1, 730, 360, 3), torch.float32, 3, 3),
                                      ((2, 13, 37, 256), torch.bfloat16, 1, 1),
                                      ((1, 5, 7, 3), torch.bfloat16, 2, 0)):
        x = torch.randn(shape, device="cuda").to(dtype)
        before = halo_exchange_w.launches
        got = halo_exchange_w(x, left, right, ring)
        assert halo_exchange_w.launches == before + 1
        for a, b in zip(got, halo_exchange_w_plain(x, left, right, ring)):
            assert torch.equal(a, b)
    assert ring.route == "self" and HaloRing.host_syncs == syncs
    ring.close()


@pytest.mark.cuda
@pytest.mark.parametrize("peers", [2, 4])
@pytest.mark.parametrize("periodic", [True, False])
def test_halo_exchange_signalled_loopback(peers, periodic):
    """The signalled route's kernels on one card: a ring of ``peers`` peers
    in this process (``LoopbackRing``: a slab and a stream each), 80
    back-to-back exchanges with fresh shards each, of several shapes, dtypes
    and halo widths (one side zero too), every halo bitwise the ring's
    (``ring_halos``)."""
    _needs_card()
    from biasgan_tpu_torch.parallel.checks import LoopbackRing, ring_halos

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(peers + 10 * periodic)
    ring = LoopbackRing(peers, periodic, 1 << 20, dev)
    for shape, dtype, left, right in (((1, 30, 12, 3), torch.float32, 3, 3),
                                      ((2, 13, 37, 64), torch.bfloat16, 1, 1),
                                      ((1, 7, 9, 5), torch.bfloat16, 2, 0),
                                      ((1, 400, 16, 256), torch.bfloat16, 0, 3)):
        rounds = [[torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(peers)]
                  for _ in range(80)]
        for xs, got in zip(rounds, ring.run(rounds, left, right)):
            for (lh, rh), (wl, wr) in zip(got, ring_halos(xs, left, right, periodic)):
                assert torch.equal(lh, wl) and torch.equal(rh, wr), (shape, left, right)
    ring.close()


@pytest.mark.cuda
def test_halo_exchange_kernel_matches_ring_across_ranks():
    """Four spawned ranks on the card(s): for every case of the CPU test,
    the kernel's padded shards equal the plain ring's bitwise, and shard 0's
    equals the whole field's wrap or zero pad."""
    _needs_card()
    from biasgan_tpu_torch.parallel import spawn
    from biasgan_tpu_torch.parallel.checks import halo_cases

    x = np.random.default_rng(0).normal(size=(2, 6, 32, 3)).astype(np.float32)
    cases = [(l, r, p) for p in (True, False) for l, r in ((1, 1), (2, 3), (3, 0), (0, 2))]
    res = spawn(halo_cases, 4, (x, cases), device="cuda", timeout=300, group_timeout=120)
    for left, right, periodic in cases:
        ring, rdma = res[(left, right, periodic, False)], res[(left, right, periodic, True)]
        np.testing.assert_array_equal(rdma, ring)
        # shard 0 padded: the whole field's pad, cut after its right halo
        whole = np.pad(x, ((0, 0), (0, 0), (left, right), (0, 0)),
                       mode="wrap" if periodic else "constant")
        np.testing.assert_array_equal(ring[:, :, :8 + left + right],
                                      whole[:, :, :8 + left + right])
    assert "wider than local shard" in res["guard"]


# ---------------------------------------------------------------------------
# K2's backward kernel (conv3x3_fused_bwd)
# ---------------------------------------------------------------------------

from biasgan_tpu_torch.kernels.conv3x3_fused import (  # noqa: E402
    conv3x3_fused_bwd,
    conv3x3_fused_bwd_plain,
)

# (prologue, act, moments, bias): every act with the prologue, none without
BWD_VARIANTS = [(True, "relu", True, True), (True, "lrelu", False, True),
                (True, "none", True, False), (False, "relu", False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 37, 32, 48), (1, 9, 5, 256, 256),
                                   (2, 2, 17, 16, 24), (2, 64, 64, 256, 256)])
def test_fused_bwd_kernel_matches_plain(dtype, shape):
    """The backward kernel against its plain version on the same inputs and
    cotangents, over every H pad with every W mode (the halo mode with
    periodic and zero-edge halo columns), the prologue under each act and
    without, moments and bias on and off; ragged tiles, H = 2 (reflect's
    rows 1 and n-2 on the edges), and the training block shape. Bounds of
    the gradient checks: f32 2e-4 max(1, |ref|) + 2e-5 |ref|, bf16 0.05
    max(1, |ref|) + 0.1 |ref|. One launch per call, each bf16 one on the
    TMA / wgmma kernels (``wgmma_launches``); a second call on the same
    arguments bitwise equal to the first (no float atomics)."""
    _needs_card()
    n, h, w, c, cout = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    rnd = lambda *s, scale=1.0: scale * torch.randn(s, generator=g, device="cuda")  # noqa: E731
    atol, rtol = (2e-4, 2e-5) if dtype == torch.float32 else (0.05, 0.1)
    i = 0
    for h_mode in ("reflect", "zero", "wrap"):
        for w_mode in ("wrap", "reflect", "zero", "halo-wrap", "halo-zero"):
            pro, act, moments, bias = BWD_VARIANTS[i % len(BWD_VARIANTS)]
            i += 1
            halo = w_mode.startswith("halo")
            x = rnd(n, h, w + 2 * halo, c)
            if w_mode == "halo-wrap":
                x[:, :, 0], x[:, :, -1] = x[:, :, -2].clone(), x[:, :, 1].clone()
            elif w_mode == "halo-zero":
                x[:, :, 0] = x[:, :, -1] = 0
            args = (x.to(dtype), rnd(cout, c, 3, 3, scale=(9 * c) ** -0.5).to(dtype),
                    rnd(cout, scale=0.1) if bias else None,
                    0.5 + torch.rand((n, c), generator=g, device="cuda") if pro else None,
                    rnd(n, c, scale=0.5) if pro else None,
                    rnd(n, h, w, cout).to(dtype), rnd(n, h, w, cout).to(dtype),
                    rnd(n, cout) if moments else None,
                    rnd(n, cout, scale=0.01) if moments else None,
                    act, h_mode, "halo" if halo else w_mode)
            before = (conv3x3_fused_bwd.launches, conv3x3_fused_bwd.wgmma_launches)
            got = conv3x3_fused_bwd(*args)
            assert conv3x3_fused_bwd.launches == before[0] + 1
            assert conv3x3_fused_bwd.wgmma_launches == before[1] + (dtype == torch.bfloat16)
            again = conv3x3_fused_bwd(*args)
            ref = conv3x3_fused_bwd_plain(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("dx", "dw", "dbias", "da", "db"), got, again):
                assert a is None or torch.equal(a, b), (name, h_mode, w_mode)
            for name, a, b in zip(("dx", "dw", "dbias", "da", "db"), got, ref):
                assert (a is None) == (b is None), name
                if a is None:
                    continue
                assert a.dtype == b.dtype and a.shape == b.shape, name
                a, b = a.float(), b.float()
                scale = max(1.0, float(b.abs().max()))
                assert bool(torch.isfinite(a).all()), (name, h_mode, w_mode)
                assert bool(((a - b).abs() <= atol * scale + rtol * b.abs()).all()), (
                    name, h_mode, w_mode, float((a - b).abs().max()) / scale)


@pytest.mark.cuda
def test_fused_bwd_bf16_kernel_refuses_what_tma_cannot_load():
    """The bf16 backward loads dYc, x and the weight slabs by TMA: C or Cout
    not a multiple of 8, or an x 2 bytes off a 16-byte boundary, raises
    and launches nothing (there is no fallback)."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16

    def args(c, cout, x=None):
        x = torch.randn((1, 8, 16, c), generator=g, device="cuda").to(bf) if x is None else x
        return (x, torch.randn((cout, c, 3, 3), generator=g, device="cuda").to(bf), None,
                None, None, torch.randn((1, 8, 16, cout), generator=g, device="cuda").to(bf),
                torch.randn((1, 8, 16, cout), generator=g, device="cuda").to(bf), None, None)

    before = (conv3x3_fused_bwd.launches, conv3x3_fused_bwd.wgmma_launches)
    for c, cout in ((12, 16), (16, 20)):
        with pytest.raises(ValueError, match="multiples of 8"):
            conv3x3_fused_bwd(*args(c, cout))
    x = torch.randn((1, 8, 16, 16), generator=g, device="cuda").to(bf)
    shifted = torch.empty(x.numel() + 1, dtype=bf, device="cuda")[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="16-byte aligned x"):
        conv3x3_fused_bwd(*args(16, 16, shifted))
    assert (conv3x3_fused_bwd.launches, conv3x3_fused_bwd.wgmma_launches) == before


# ---------------------------------------------------------------------------
# K7's backward kernel (instance_norm_act_bwd)
# ---------------------------------------------------------------------------

from biasgan_tpu_torch.kernels import instance_norm_act as k7_mod  # noqa: E402
from biasgan_tpu_torch.kernels.instance_norm_act import (  # noqa: E402
    instance_norm_act_bwd,
    instance_norm_act_bwd_plain,
    instance_norm_stats_plain,
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 13, 37, 64), (1, 1, 1, 8)])
def test_norm_bwd_kernel_matches_plain(dtype, shape):
    """The backward kernel against its plain version on the same arguments:
    x, the forward kernel's output and saved statistics, a random
    cotangent; every act with and without a residual. dx within the
    gradient bounds (f32 2e-4 max(1, |ref|) + 2e-5 |ref|, bf16 0.05
    max(1, |ref|) + 0.1 |ref|); d_res, an elementwise g x {0, 0.2, 1} in f32
    cast once, bitwise; at H W = 1, dx exactly 0. One launch per call, on
    the one-launch cluster path (which both shapes take) and the two-pass
    one."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    atol, rtol = (2e-4, 2e-5) if dtype == torch.float32 else (0.05, 0.1)
    for act in ("none", "relu", "lrelu"):
        for has_res in (False, True):
            x = (3 * torch.randn(shape, generator=g, device="cuda") + 1).to(dtype)
            r = torch.randn(shape, generator=g, device="cuda").to(dtype) if has_res else None
            stats = torch.empty((2, shape[0], shape[3]), device="cuda")
            out = k7_mod._launch(x, r, act, 1e-5, stats)
            ref_stats = instance_norm_stats_plain(x)
            assert bool(((stats - ref_stats).abs() <= 1e-4 * (1 + ref_stats.abs())).all())
            cot = torch.randn(shape, generator=g, device="cuda").to(dtype)
            rdx, rd_res = instance_norm_act_bwd_plain(x, out, cot, stats, act, has_res)
            for two_pass in (False, True):
                where = (act, has_res, two_pass)
                before = instance_norm_act_bwd.launches
                dx, d_res = instance_norm_act_bwd(x, out, cot, stats, act, has_res,
                                                  two_pass=two_pass)
                assert instance_norm_act_bwd.launches == before + 1
                torch.cuda.synchronize()
                assert dx.dtype == dtype and dx.shape == x.shape
                a, b = dx.float(), rdx.float()
                scale = max(1.0, float(b.abs().max()))
                assert bool(torch.isfinite(a).all()), where
                assert bool(((a - b).abs() <= atol * scale + rtol * b.abs()).all()), (
                    where, float((a - b).abs().max()) / scale)
                if shape[1] * shape[2] == 1:
                    assert bool((dx == 0).all()), where
                assert (d_res is None) == (not has_res)
                if has_res:
                    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                    assert d_res.dtype == dtype and torch.equal(d_res.view(bits),
                                                                rd_res.view(bits)), where

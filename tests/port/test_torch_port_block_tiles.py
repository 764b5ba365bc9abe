"""The fused block conv as its bf16 CUDA kernel computes it
(biasgan_tpu_torch/kernels/csrc/conv3x3_fused.cu, conv_tma_kernel),
emulated in torch on the CPU from the wrapper's own pieces: C and Cout
padded to multiples of 8 (``pad_channels``, ``pad_couts``), the tile's couts
from ``tile_geometry``, the weight slabs of ``pack_block_weight``, a and b
zero past C to whole 64-channel blocks; per tile of
TH x TW pixels and channel block, the (TH + 2) x (TW + 2) box of x with
TMA's zero fill past every edge, origin column x0 - 1 or x0 in the halo
mode; on a tile whose pad reflects or wraps, the side rows and columns
loaded from their source row or column and each corner from (source row,
source column), as the producer loads them; each position read from the
buffer the consumer's lane points at; the prologue on positions that hold
data only (a zero pad or a zero fill stays zero, never act(b)); f32
accumulation of the nine taps against the slabs, bias, one cast, and the
moments of the stored value summed tile by tile.

The emulation is held to the wrapper's plain version (which the CPU takes)
and to the JAX Pallas kernel in interpret mode, as
test_torch_port_conv3x3_fused.py runs it, in every h_mode x w_mode pair
(the halo mode included), with and without the prologue, in f32 and bf16,
on tiles that touch both edges at once (H <= TH, W <= TW: both side rows
and columns and all four corners) and on ragged multi-tile shapes. The
card holds the kernel to the plain version (test_torch_port_cuda.py,
chip_smoke.py).

Tolerances: y within f32 1e-5, bf16 2e-2 (|d| <= tol (1 + |ref|)); moments
in f32 within 1e-4 relative, and in both dtypes no further from the
reference's than the stored outputs are, plus 1e-5 of summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from biasgan_tpu.ops.pallas_conv import conv3x3_fused as jax_conv3x3_fused
from biasgan_tpu.ops.pallas_conv import embed_halo_w, fused_block_plan
from biasgan_tpu_torch.kernels.common import act_f32, pad_channels, pad_couts
from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused_plain
from biasgan_tpu_torch.kernels.conv_tma import KW, TH, TW, pack_block_weight, tile_geometry

H_MODES = ("reflect", "zero", "wrap")
W_MODES = ("wrap", "zero", "reflect", "halo")


def _tma(xz, rows, cols):
    """What a TMA box of input ``rows`` x ``cols`` (1-D index tensors) of
    an image brings: zero past every edge. ``xz`` is the image (H, W, C)
    with a zero row H and a zero column W appended, where every index past
    an edge points."""
    h, w = xz.shape[0] - 1, xz.shape[1] - 1
    r = torch.where((rows >= 0) & (rows < h), rows, h)
    q = torch.where((cols >= 0) & (cols < w), cols, w)
    return xz[r][:, q]


def _source(hi, n, mode):
    """The input row or column a reflected or wrapped pad -1 (hi False) or
    n (hi True) copies."""
    if mode == "reflect":
        return n - 2 if hi else 1
    return 0 if hi else n - 1


def _tile_view(xz, y0, x0, h, w, h_mode, w_mode):
    """The (TH + 2, TW + 2, C) values the consumer's lanes read for tile
    (y0, x0) of an image (``_tma``'s ``xz``), and whether each position
    holds data (input data, or a pad that reflects or wraps)."""
    win = xz.shape[1] - 1
    h_data, w_data = h_mode != "zero", w_mode in ("reflect", "wrap")
    ys = torch.arange(y0 - 1, y0 + TH + 1)
    xs = torch.arange(TW + 2) + (x0 if w_mode == "halo" else x0 - 1)
    view = _tma(xz, ys, xs)  # the box
    row_side = ((ys == -1) | (ys == h)) & h_data  # pads read from the side buffers
    col_side = ((xs == -1) | (xs == w)) & w_data
    real = ((((ys >= 0) & (ys < h)) | row_side)[:, None]
            & (((xs >= 0) & (xs < win)) | col_side)[None, :])
    # the producer's side loads, and the lanes that point at them: a pad
    # row from its source row, a pad column from its source column, a
    # corner from (source row, source column)
    for i in row_side.nonzero().flatten().tolist():
        src = torch.tensor([_source(ys[i] != -1, h, h_mode)])
        view[i, ~col_side] = _tma(xz, src, xs)[0, ~col_side]
    for j in col_side.nonzero().flatten().tolist():
        src = torch.tensor([_source(xs[j] != -1, w, w_mode)])
        view[~row_side, j] = _tma(xz, ys, src)[~row_side, 0]
        for i in row_side.nonzero().flatten().tolist():
            view[i, j] = _tma(xz, torch.tensor([_source(ys[i] != -1, h, h_mode)]), src)[0, 0]
    return view, real[..., None]


def emulate(x, weight, bias, prologue, act, h_mode, w_mode, sms=132):
    """conv3x3_fused the bf16 kernel's way, in x's dtype (f32 or bf16), on a
    card of ``sms`` SMs (which sets the tile's couts)."""
    n, h, wx = x.shape[:3]
    w = wx - 2 if w_mode == "halo" else wx
    cout = weight.shape[0]
    x, weight, prologue = pad_channels(x, weight, prologue)
    weight, bias = pad_couts(weight, bias)
    c, cout_k = x.shape[3], weight.shape[0]
    packed = pack_block_weight(weight.to(x.dtype), tile_geometry(n, h, w, cout_k, sms))
    n_kc = -(-c // KW)
    xk = F.pad(x, (0, n_kc * KW - c))  # TMA's zero fill of the channels past C
    if prologue is not None:
        a, b = (F.pad(t.float(), (0, n_kc * KW - c)) for t in prologue)
    tiles = [(i, y0, x0) for i in range(n) for y0 in range(0, h, TH) for x0 in range(0, w, TW)]
    views = []
    for i, y0, x0 in tiles:
        xz = F.pad(xk[i], (0, 0, 0, 1, 0, 1))  # a zero row and column past the image
        view, real = _tile_view(xz, y0, x0, h, w, h_mode, w_mode)
        if prologue is not None:  # on data only, one rounding
            t = act_f32(view.float() * a[i] + b[i], act).to(x.dtype)
            view = torch.where(real, t, torch.zeros((), dtype=x.dtype))
        views.append(view)
    # every tile's A rows at each tap (the one-pixel shifts of its box)
    # against the slabs, in the slabs' (channel block, tap) order, f32
    v = torch.stack(views)
    taps = torch.stack([v[:, dy:dy + TH, dx:dx + TW] for dy in range(3) for dx in range(3)], 3)
    taps = taps.reshape(len(tiles), TH * TW, 9, n_kc, KW).transpose(2, 3)
    cout_pad = packed.shape[1]
    wk = packed.reshape(n_kc, 9, cout_pad, KW).permute(2, 0, 1, 3).reshape(cout_pad, -1)
    acc = taps.reshape(len(tiles), TH * TW, -1).float() @ wk.float().T
    if bias is not None:  # zero past Cout
        acc = acc + F.pad(bias.float(), (0, cout_pad - cout_k))
    stored = acc.to(x.dtype).reshape(len(tiles), TH, TW, cout_pad)
    y = torch.zeros((n, h, w, cout_pad), dtype=x.dtype)
    sums = torch.zeros((n, cout_pad))
    sqs = torch.zeros((n, cout_pad))
    for tile, (i, y0, x0) in zip(stored, tiles):  # the moments of the stored value, by tile
        ny, nx = min(TH, h - y0), min(TW, w - x0)
        y[i, y0:y0 + ny, x0:x0 + nx] = tile[:ny, :nx]
        sums[i] += tile[:ny, :nx].float().sum((0, 1))
        sqs[i] += tile[:ny, :nx].float().square().sum((0, 1))
    return y[..., :cout], (sums[:, :cout], sqs[:, :cout])


def _data(n, h, w, c, cout, dtype, seed, prologue, w_mode):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w + 2 * (w_mode == "halo"), c)).astype(np.float32)
    k = (rng.normal(size=(cout, c, 3, 3)) / (9 * c) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    pro = None
    if prologue:
        pro = ((rng.random((n, c)) + 0.5).astype(np.float32),
               (rng.normal(size=(n, c)) * 0.5).astype(np.float32))
    td = getattr(torch, dtype)
    xt, kt = torch.from_numpy(x).to(td), torch.from_numpy(k).to(td)
    prot = None if pro is None else tuple(map(torch.from_numpy, pro))
    return (x, k, b, pro), (xt, kt, torch.from_numpy(b), prot)


def _compare(got, want, dtype):
    (y, (s, q)), (ry, (rs, rq)) = got, want
    assert y.shape == ry.shape and y.dtype == ry.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    yf, rf = y.float(), ry.float()
    assert bool(((yf - rf).abs() <= tol * (1 + rf.abs())).all()), float((yf - rf).abs().max())
    if dtype == "float32":
        torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(q, rq, rtol=1e-4, atol=1e-4)
    dims = (1, 2)
    dsum = (yf - rf).abs().sum(dims) + 1e-5 * rf.abs().sum(dims)
    dsq = (yf.square() - rf.square()).abs().sum(dims) + 1e-5 * rf.square().sum(dims)
    assert bool(((s - rs).abs() <= dsum).all())
    assert bool(((q - rq).abs() <= dsq).all())


# (n, h, w, C, Cout, sms): one tile touching all four edges (C 12 and
# Cout 20 padded by the wrapper); three ragged tiles across and two down,
# C 72 in two channel blocks, Cout 136 in two 128-cout tiles (the picker's
# choice at 132 SMs) or one 256-cout tile (at 4 SMs)
SHAPES = [(2, 5, 9, 12, 20, 132), (1, 13, 37, 72, 136, 132), (1, 13, 37, 72, 136, 4)]
PLAIN_CASES = [(s, hm, wm, d, p) for s in range(len(SHAPES)) for hm in H_MODES
               for wm in W_MODES for d in ("float32", "bfloat16") for p in (False, True)
               if s == 0 or (p and (s == 1 or d == "bfloat16"))]


@pytest.mark.parametrize("shape,h_mode,w_mode,dtype,prologue", PLAIN_CASES)
def test_block_tile_emulation_matches_plain(shape, h_mode, w_mode, dtype, prologue):
    n, h, w, c, cout, sms = SHAPES[shape]
    _, (x, k, b, pro) = _data(n, h, w, c, cout, dtype, seed=shape + len(h_mode + w_mode),
                              prologue=prologue, w_mode=w_mode)
    args = (x, k, b, pro, "relu", h_mode, w_mode)
    _compare(emulate(*args, sms=sms), conv3x3_fused_plain(*args), dtype)


@pytest.mark.parametrize("act", ["none", "lrelu"])
def test_block_tile_emulation_activations(act):
    """The prologue's other activations: act(b) of a zero fill must stay 0
    (lrelu(b) and b are not 0), here on a tile touching every edge."""
    _, (x, k, b, pro) = _data(2, 5, 9, 8, 16, "float32", seed=7, prologue=True,
                              w_mode="zero")
    args = (x, k, b, pro, act, "zero", "zero")
    _compare(emulate(*args), conv3x3_fused_plain(*args), "float32")


# the JAX plan needs W % 8 == 0 and H >= 3: 5 x 16 is one tile touching
# all four edges, every mode pair, f32 and bf16 in turn, with the
# prologue (and two pairs without); 13 x 24 two tiles down and two across
# (the second ragged)
JAX_SHAPES = [(2, 5, 16, 8, 8), (1, 13, 24, 16, 24)]
JAX_CASES = ([(0, hm, wm, ("float32", "bfloat16")[i % 2], True)
              for i, (hm, wm) in enumerate((hm, wm) for hm in H_MODES for wm in W_MODES)]
             + [(0, "zero", "zero", "float32", False), (0, "reflect", "halo", "bfloat16", False)]
             + [(1, hm, wm, "bfloat16", True) for hm, wm in (("reflect", "wrap"), ("zero", "halo"),
                                                             ("wrap", "reflect"), ("zero", "zero"))])


@pytest.mark.parametrize("shape,h_mode,w_mode,dtype,prologue", JAX_CASES)
def test_block_tile_emulation_matches_pallas_interpret(shape, h_mode, w_mode, dtype, prologue):
    """Corners, side rows and columns against the Pallas kernel's own pad;
    in the halo mode the input carries its two columns."""
    n, h, w, c, cout = JAX_SHAPES[shape]
    (xn, kn, bn, pron), (x, k, b, pro) = _data(n, h, w, c, cout, dtype, seed=20 + shape,
                                               prologue=prologue, w_mode=w_mode)
    jd = getattr(jnp, dtype)
    plan = fused_block_plan(h, w, c, cout, jd, interpret=True)
    xe = jnp.asarray(xn).astype(jd)
    xe = embed_halo_w(xe) if w_mode == "halo" else xe
    xe = jnp.pad(xe, ((0, 0), (0, plan.h_run - h), (0, 0), (0, 0)))
    yj, (sj, qj) = jax_conv3x3_fused(
        xe, jnp.asarray(kn.transpose(2, 3, 1, 0)).astype(jd), jnp.asarray(bn),
        prologue=None if pron is None else tuple(map(jnp.asarray, pron)), act_pre="relu",
        plan=plan,
        h_mode=h_mode, w_mode=w_mode, want_moments=True)
    want = (torch.from_numpy(np.array(yj[:, :h].astype(jnp.float32))).to(x.dtype),
            (torch.from_numpy(np.array(sj)), torch.from_numpy(np.array(qj))))
    _compare(emulate(x, k, b, pro, "relu", h_mode, w_mode), want, dtype)


def test_tile_geometry_at_the_main_path_shapes():
    """The couts of the tile at 132 SMs, and the rounds of the persistent
    grid that the kernel's header reckons: the globe's 520 pixel tiles
    (four rounds) and the 4-way shard's halo mode (130: one round) on 256
    couts; training at batch 1 on 128 (80 half tiles: one round), at batch
    2 and 3 on 256."""
    assert tile_geometry(1, 181, 360, 256, 132) == 256
    assert tile_geometry(1, 181, 90, 256, 132) == 256
    assert [tile_geometry(b, 64, 64, 256, 132) for b in (1, 2, 3)] == [128, 256, 256]
    assert tile_geometry(4, 300, 300, 48, 132) == 128  # Cout <= 128
    assert -(-181 // TH) * -(-360 // TW) == 520 and -(-181 // TH) * -(-90 // TW) == 130


@pytest.mark.parametrize("c,cout,bn", [(8, 24, 128), (72, 136, 128), (72, 136, 256),
                                       (256, 256, 256)])
def test_packed_weight_holds_every_tap_once(c, cout, bn):
    """Packed indices: each (cout, c, dy, dx) of the OIHW weight lands once,
    in slab 9 cb + 3 dy + dx at row cout, column c - 64 cb; the rest is
    zero."""
    idx = torch.arange(1, cout * c * 9 + 1).reshape(cout, c, 3, 3)
    packed = pack_block_weight(idx, bn)
    n_kc = -(-c // KW)
    assert packed.shape == (9 * n_kc, -(-cout // bn) * bn, KW)
    assert torch.equal(packed[packed > 0].sort().values, idx.flatten())
    for cb in range(n_kc):
        for tap in range(9):
            slab = packed[9 * cb + tap]
            real = idx[:, cb * KW:(cb + 1) * KW, tap // 3, tap % 3]
            assert torch.equal(slab[:cout, :real.shape[1]], real)
            assert not slab[cout:].any() and not slab[:, real.shape[1]:].any()

"""CPU checks of the identities K2's bf16 backward kernels rely on
(csrc/conv3x3_fused_bwd.cu on the shared loop of csrc/conv3x3_tma.cuh),
emulated in torch from the wrapper's pieces, f32, tiny shapes, and held to
``conv3x3_fused_bwd_plain`` (which ``test_torch_port_fused_bwd.py`` holds
to the JAX VJP):

* the input gradient, tile by tile as the dgrad launch walks it (7 x 18
  tiles of dU, the box of dYc one row and column up-left of the tile, two
  columns in the halo mode, the packed channel-transposed weight's slabs
  read in reverse): a zero pad's adjoint is the zero-padded full conv of
  dYc, a wrap pad's the wrap-padded one, the halo mode's the zero pad of 2
  on W; a reflect pad's is the zero-padded full conv onto the padded
  output, its tile grid from the origin ``tile_grid`` picks, and the pad
  rows (columns) folded onto rows 1 and n-2 inside the tile in f32, rows
  first; then the prologue's chain in the epilogue, with da and db summed
  per tile in the tiles' order;
* the weight gradient as the split-K sum of the wgrad launch: u_pad (the
  forward's pad of the prologue'd input, written once by prep), per 8 x 16
  tile of dYc the box of u_pad shifted by the tap's column (rows y0 ..
  y0 + 9, columns x0 + tb ..), whose rows from (ty + ta) 16 are tap
  (ta, tb)'s 16 pixels of tile row ty, against dYc's tile row: a k16 step
  per (tap, tile row); each split the tiles s, s + S, ..., the splits
  added in order;
* the dgrad weight pack's shape and slab order (prep's PackW writes this
  layout on the card).
"""

import pytest
import torch

from biasgan_tpu_torch.kernels import conv_tma
from biasgan_tpu_torch.kernels.common import act_f32
from biasgan_tpu_torch.kernels.conv3x3_fused import conv3x3_fused_bwd_plain
from biasgan_tpu_torch.ops.padding import pad_hw

TH, TW = conv_tma.TH, conv_tma.TW


def _pad1(t, mode, axis):
    """A pad of 1 on ``axis`` of NHWC ``t`` (zero or wrap)."""
    if mode == "wrap":
        n = t.shape[axis]
        return torch.cat([t.narrow(axis, n - 1, 1), t, t.narrow(axis, 0, 1)], axis)
    shape = list(t.shape)
    shape[axis] = 1
    z = t.new_zeros(shape)
    return torch.cat([z, t, z], axis)


def _window(t, y0, x0, h, w):
    """Rows y0 .. y0+h-1, columns x0 .. x0+w-1 of NHWC ``t``, zero outside
    (TMA's zero fill)."""
    n, hh, ww, c = t.shape
    out = t.new_zeros((n, h, w, c))
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + h, hh), min(x0 + w, ww)
    if ye > ys and xe > xs:
        out[:, ys - y0:ye - y0, xs - x0:xe - x0] = t[:, ys:ye, xs:xe]
    return out


def tile_grid(n, tile, fold):
    """csrc/conv3x3_tma.cuh tile_grid: the grid's origin and tiles along an
    axis of n outputs (on a folded axis, over the padded output from the
    origin nearest -1 whose tiles hold rows -1, 1 and n-2, n together)."""
    o = 0
    if fold:
        o = -1
        while o > 2 - tile and (n - o) % tile < 2:
            o -= 1
    return o, -(-(n + fold - o) // tile)


def dgrad_emulated(dyc, weight, h_mode, w_mode, bn=128):
    """dU (N, H, Win, C) as the dgrad launch computes it (see the module
    docstring), f32."""
    n, h, w, cout = dyc.shape
    c = weight.shape[1]
    halo = w_mode == "halo"
    win = w + 2 if halo else w
    slabs = conv_tma.pack_block_weight(weight.transpose(0, 1), bn).float()
    n_kc = slabs.shape[0] // 9
    fold_h, fold_w = h_mode == "reflect", w_mode == "reflect"
    # the dgrad's input pads: a wrapped axis wraps dYc, any other is zero
    # (TMA's zero fill): dYc at offset (pad, pad) of a padded source
    pad = 8
    src = torch.nn.functional.pad(dyc, (0, 0, pad, pad, pad, pad))
    if h_mode == "wrap":
        src[:, pad - 1, pad:pad + w], src[:, pad + h, pad:pad + w] = dyc[:, h - 1], dyc[:, 0]
    if w_mode == "wrap":  # the wrapped columns, their wrapped corners too
        src[:, :, pad - 1] = src[:, :, pad + w - 1]
        src[:, :, pad + w] = src[:, :, pad]
    x_off = -2 if halo else -1  # the box's first column, from the tile's

    def slab(t):  # tap t's matrix under flip: (Cout, C) from slab 8 - t
        return torch.cat([slabs[9 * cb + 8 - t, :c].T for cb in range(n_kc)], 0)[:cout]

    oy, tiles_y = tile_grid(h, TH, fold_h)
    ox, tiles_x = tile_grid(win, TW, fold_w)
    du = dyc.new_zeros((n, h, win, c))
    for i in range(tiles_y):
        for j in range(tiles_x):
            y0, x0 = oy + TH * i, ox + TW * j
            box = _window(src, y0 - 1 + pad, x0 + x_off + pad, TH + 2, TW + 2)
            acc = dyc.new_zeros((n, TH, TW, c))
            for t in range(9):
                ta, tb = divmod(t, 3)
                acc += box[:, ta:ta + TH, tb:tb + TW] @ slab(t)
            # the folds, rows first: the pad line's sums onto line 1 (n-2)
            for src_line, dst_line, size, axis, on in (
                    (-1 - y0, 1 - y0, TH, 1, fold_h), (h - y0, h - 2 - y0, TH, 1, fold_h),
                    (-1 - x0, 1 - x0, TW, 2, fold_w), (win - x0, win - 2 - x0, TW, 2, fold_w)):
                if on and 0 <= src_line < size:
                    assert 0 <= dst_line < size  # tile_grid keeps each pair in one tile
                    acc.narrow(axis, dst_line, 1).add_(acc.narrow(axis, src_line, 1))
            ys, xs = max(y0, 0), max(x0, 0)
            ye, xe = min(y0 + TH, h), min(x0 + TW, win)
            du[:, ys:ye, xs:xe] = acc[:, ys - y0:ye - y0, xs - x0:xe - x0]
    return du


def chain_emulated(du, x, a, b, act):
    """The DGRAD epilogue: dx = dpre a, and da, db summed per tile (each
    tile's f32 sum over its real pixels), the tiles in order."""
    pre = x * a[:, None, None] + b[:, None, None]
    slope = {"relu": (pre > 0).float(), "lrelu": torch.where(pre > 0, 1.0, 0.2),
             "none": torch.ones_like(pre)}[act]
    dpre = du * slope
    n, h, w, c = x.shape
    da = x.new_zeros((n, c))
    db = x.new_zeros((n, c))
    for y0 in range(0, h, TH):
        for x0 in range(0, w, TW):
            tile = (slice(None), slice(y0, y0 + TH), slice(x0, x0 + TW))
            da += (dpre[tile] * x[tile]).sum((1, 2))
            db += dpre[tile].sum((1, 2))
    return dpre * a[:, None, None], da, db


WG_TH, WG_TW = 8, 16  # the wgrad's tile of dYc pixels


def wgrad_emulated(u, dyc, h_mode, w_mode, splits):
    """dW (Cout, C, 3, 3) as the wgrad launch sums it: the split-K partials
    over the pixel tiles, added in split order."""
    n, h, w, cout = dyc.shape
    c = u.shape[3]
    halo = w_mode == "halo"
    up = pad_hw(u, (1, 1), (0, 0) if halo else (1, 1), h_mode, "zero" if halo else w_mode)
    tiles = [(i, y0, x0) for i in range(n) for y0 in range(0, h, WG_TH)
             for x0 in range(0, w, WG_TW)]
    parts = []
    for s in range(splits):
        acc = dyc.new_zeros((9, c, cout))
        for i, y0, x0 in tiles[s::splits]:
            g = _window(dyc[i:i + 1], y0, x0, WG_TH, WG_TW)[0]  # zero past the edge
            for tb in range(3):
                box = _window(up[i:i + 1], y0, x0 + tb, WG_TH + 2, WG_TW)[0]
                rows = box.reshape((WG_TH + 2) * WG_TW, c)
                for ta in range(3):
                    for ty in range(WG_TH):  # a k16 step: 16 box rows from (ty + ta) 16
                        a = rows[(ty + ta) * WG_TW:(ty + ta + 1) * WG_TW]
                        acc[3 * ta + tb] += a.T @ g[ty]
        parts.append(acc)
    dw = parts[0]
    for p in parts[1:]:
        dw = dw + p
    return dw.reshape(3, 3, c, cout).permute(3, 2, 0, 1)


MODES = [("zero", "zero"), ("wrap", "wrap"), ("reflect", "wrap"), ("reflect", "reflect"),
         ("zero", "reflect"), ("wrap", "halo"), ("reflect", "halo")]


@pytest.mark.parametrize("h_mode,w_mode", MODES)
@pytest.mark.parametrize("shape", [(2, 9, 20, 16, 24), (1, 2, 5, 8, 8)])
def test_design_matches_plain_backward(h_mode, w_mode, shape):
    """The emulated dgrad (pad adjoint by zero fill, wrap, or the folds),
    its epilogue chain, and the split-K wgrad against the plain backward,
    f32, with the prologue (lrelu) on; a shape with ragged tiles on both
    axes and one with H = 2 (rows 1 and n-2 swap) in one tile."""
    n, h, w, c, cout = shape
    g = torch.Generator().manual_seed(sum(shape))
    halo = w_mode == "halo"
    x = torch.randn((n, h, w + 2 * halo, c), generator=g)
    weight = torch.randn((cout, c, 3, 3), generator=g) * (9 * c) ** -0.5
    bias = 0.1 * torch.randn(cout, generator=g)
    a = 0.5 + torch.rand((n, c), generator=g)
    b = 0.5 * torch.randn((n, c), generator=g)
    y = torch.randn((n, h, w, cout), generator=g)
    dy = torch.randn((n, h, w, cout), generator=g)
    ds = torch.randn((n, cout), generator=g)
    dq = 0.01 * torch.randn((n, cout), generator=g)
    ref = conv3x3_fused_bwd_plain(x, weight, bias, a, b, y, dy, ds, dq, "lrelu", h_mode, w_mode)

    dyc = dy + ds[:, None, None] + 2 * dq[:, None, None] * y  # prep: the moments' pullback
    du = dgrad_emulated(dyc, weight, h_mode, w_mode)
    dx, da, db = chain_emulated(du, x, a, b, "lrelu")
    u = act_f32(x * a[:, None, None] + b[:, None, None], "lrelu")
    dw = wgrad_emulated(u, dyc, h_mode, w_mode, splits=3)
    for name, got, want in (("dx", dx, ref[0]), ("dw", dw, ref[1]), ("da", da, ref[3]),
                            ("db", db, ref[4])):
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max()) / scale
        assert err < 1e-5, (name, err)


def test_design_wrap_and_zero_are_padded_full_convs():
    """A wrap (zero) pad's adjoint is the wrap- (zero-) padded full conv of
    dYc with the flipped, channel-transposed weight; a halo mode's the
    zero pad of 2 on W (the conv the input gradient of a VALID conv is)."""
    g = torch.Generator().manual_seed(3)
    dyc = torch.randn((2, 9, 20, 24), generator=g)
    weight = torch.randn((24, 16, 3, 3), generator=g)
    wt = weight.flip(2, 3).transpose(0, 1)  # (C, Cout, 3, 3)
    conv = torch.nn.functional.conv2d
    for mode in ("wrap", "zero"):
        padded = _pad1(_pad1(dyc, mode, 1), mode, 2).permute(0, 3, 1, 2)
        want = conv(padded, wt).permute(0, 2, 3, 1)
        torch.testing.assert_close(dgrad_emulated(dyc, weight, mode, mode), want,
                                   rtol=1e-5, atol=1e-4)
    want = conv(dyc.permute(0, 3, 1, 2), wt, padding=(1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(dgrad_emulated(dyc, weight, "zero", "halo"), want,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tile", [TH, TW])
def test_fold_grid_keeps_each_fold_in_one_tile(tile):
    """tile_grid on a folded axis, for every size from 2 to 200: the origin
    lies in -1 .. -(tile - 2); one tile holds rows -1 and 1, one tile rows
    n-2 and n; the tiles cover the padded rows -1 .. n."""
    for n in range(2, 201):
        o, tiles = tile_grid(n, tile, True)
        assert 2 - tile <= o <= -1
        assert (1 - o) // tile == (-1 - o) // tile
        assert (n - o) // tile == (n - 2 - o) // tile
        assert o + tiles * tile >= n + 1 > o + (tiles - 1) * tile
        assert tile_grid(n, tile, False) == (0, -(-n // tile))


@pytest.mark.parametrize("c,cout,bn", [(256, 256, 256), (16, 24, 128), (72, 136, 128)])
def test_dgrad_weight_pack_shape_and_slab_order(c, cout, bn):
    """pack_block_weight of the channel-transposed weight: (9 ceil(Cout /
    64), C rounded up to bn, 64); slab 9 cb + 3 dy + dx holds W[64 cb + k,
    o, dy, dx] at [o, k], zero past C and Cout: tap t of the dgrad reads
    slab 8 - t (weight (2 - dy, 2 - dx))."""
    weight = torch.randn((cout, c, 3, 3), generator=torch.Generator().manual_seed(c))
    p = conv_tma.pack_block_weight(weight.transpose(0, 1), bn)
    n_kc = -(-cout // 64)
    assert p.shape == (9 * n_kc, -(-c // bn) * bn, 64)
    for cb in range(n_kc):
        for t in range(9):
            dy_, dx_ = divmod(t, 3)
            k = min(64, cout - 64 * cb)
            torch.testing.assert_close(p[9 * cb + t, :c, :k],
                                       weight[64 * cb:64 * cb + k, :, dy_, dx_].T,
                                       rtol=0, atol=0)
            assert not p[9 * cb + t, c:].any() and not p[9 * cb + t, :, k:].any()

"""The 7x7 stem / head conv (K3) as its bf16 CUDA kernels compute it
(biasgan_tpu_torch/kernels/csrc/conv7x7.cu: stem_wgmma_kernel,
head_wgmma_kernel), emulated in torch on the CPU from the wrapper's own
pieces: ``bf16_operands`` (the stem's Cout rounded up to 8 and its bias to
the packed couts; the head's C rounded up to 8 and its rows per unit from
``head_rows``), the weights packed by ``pack_stem_weight`` and
``pack_head_weight``, and the persistent grids' walks across images.

The stem: per 8 x 64 output tile, the (8 + 6) x 71 staged units of P
pixels at 8 / P channels (``stem_pixels``: Cin_p 4 for Cin <= 4, else 8),
zero past Cin and past the input; per output row and dy, each pixel's A row
is the 8 / P units from its own, one run (dx 7 against zero weights); the
64-cout blocks one launch each; f32 sums, f32 bias, one cast, stored
clipped to the image. The head: per unit (a 64-column strip of ``th``
output rows), each staged row's box of 70 pixels x 64 channels per channel
block (TMA's zero fill past the image and past C), its product U with the
(dx, channel block) slabs that put (dy, co) on N, the dy collapse into a
window of seven output-row partials that shifts each staged row, f32 bias,
one cast.

Held to the wrapper's plain version ``conv7x7_plain`` (what the CPU takes)
in f32 and bf16, on: Cin 1, 3, 8 with Cout 5, 64, 136 (136: three 64-cout
launches, the last ragged); Cout 1, 3, 8 with C 9, 64, 72 (72: two channel
blocks); tiles and units touching both edges of the image; batch 2 with
more stem tiles than the card's 132 SMs and head units walked in several
rounds across images. Also to the JAX Pallas ``conv7x7_valid`` in interpret
mode at widths its wrapper takes; and the packs hold every (tap, ci, co)
of the weight exactly once. The card holds the kernels to the plain version
(test_torch_port_cuda.py, chip_smoke.py).

Tolerances: f32 1e-5, bf16 2e-2 (|d| <= tol (1 + |ref|)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from biasgan_tpu.ops.pallas_conv7 import conv7x7_valid as jax_conv7x7_valid
from biasgan_tpu_torch.kernels.conv7x7 import (
    HEAD_NC,
    HEAD_TW,
    STEM_TH,
    STEM_TW,
    bf16_operands,
    conv7x7_plain,
    pack_head_weight,
    pack_stem_weight,
)

SMS = 132  # the H100's SMs: the persistent grids' blocks


def _box(img, rows, cols):
    """What a box of rows x cols (1-D index tensors) of one image (H, W, C)
    holds: zero outside the image (TMA's zero fill, the stem's staging)."""
    h, w = img.shape[:2]
    z = F.pad(img, (0, 0, 0, 1, 0, 1))
    r = torch.where((rows >= 0) & (rows < h), rows, h)
    q = torch.where((cols >= 0) & (cols < w), cols, w)
    return z[r][:, q]


def stem_walk(n, h, w, sms):
    """The stem's tiles (image, y0, x0), block by block, each block's in its
    walk order (t from the block's index in steps of the grid, x fastest)."""
    tiles_x, tiles_y = -(-w // STEM_TW), -(-h // STEM_TH)
    total = n * tiles_x * tiles_y
    grid = min(total, sms)
    out = []
    for block in range(grid):
        for t in range(block, total, grid):
            rest = t // tiles_x
            out.append((rest // tiles_y, rest % tiles_y * STEM_TH, t % tiles_x * STEM_TW))
    return out


def head_walk(n, h, w, th, sms):
    """The head's units (image, y0, x0), warpgroup by warpgroup (a block's
    HEAD_NC consumer warpgroups each walk their own: u from the warpgroup's
    index in steps of all of the grid's), strips of a segment together."""
    n_seg, n_strip = -(-h // th), -(-w // HEAD_TW)
    units = n * n_seg * n_strip
    slots = min(sms, -(-units // HEAD_NC)) * HEAD_NC
    out = []
    for gw in range(slots):
        for u in range(gw, units, slots):
            rest = u // n_strip
            out.append((rest // n_seg, rest % n_seg * th, u % n_strip * HEAD_TW))
    return out


def emulate_stem(xp, weight, bias, sms=SMS):
    n, hp, wp, cin = xp.shape
    cout = weight.shape[0]
    xk, packed, b, cout_k, p, _ = bf16_operands(xp, weight, bias, sms)
    h, w, cp, spd = hp - 6, wp - 6, 8 // p, 4 // p
    units = STEM_TW + 7
    tiles = stem_walk(n, h, w, sms)
    assert len(set(tiles)) == len(tiles)  # every tile once
    y = torch.zeros((n, h, w, cout_k), dtype=xp.dtype)
    for cb in range(packed.shape[0]):  # one launch per 64 couts
        slabs = packed[cb, :, :, :16 * spd].float()  # (7 dy, 64 couts, K)
        bias_k = torch.zeros(64) if b is None else b[64 * cb:64 * cb + 64]
        for i, y0, x0 in tiles:
            px = _box(xk[i], torch.arange(STEM_TH + 6) + y0, torch.arange(units + p - 1) + x0)
            px = F.pad(px, (0, cp - cin))  # zero past Cin
            st = torch.cat([px[:, d:d + units] for d in range(p)], -1)  # (rows, units, 8)
            for r in range(STEM_TH):
                acc = torch.zeros((STEM_TW, 64))
                for dy in range(7):
                    # pixel m's A row: the 2 spd units m, m + P, ..., one run
                    a = torch.stack([st[r + dy, p * c8:p * c8 + STEM_TW] for c8 in range(2 * spd)],
                                    1).reshape(STEM_TW, 16 * spd).float()
                    acc = acc + a @ slabs[dy].T
                row = (acc + bias_k).to(xp.dtype)
                if y0 + r < h:
                    nx, nc = min(STEM_TW, w - x0), min(64, cout_k - 64 * cb)
                    y[i, y0 + r, x0:x0 + nx, 64 * cb:64 * cb + nc] = row[:nx, :nc]
    return y[..., :cout]


def head_columns(cout, cpl):
    """U's column of (dy, co), as pack_head_weight lays out N."""
    return [[8 * (dy // 2) + 2 * co + dy % 2 if cpl == 1 else 8 * dy + co for co in range(cout)]
            for dy in range(7)]


def emulate_head(xp, weight, bias, sms=SMS):
    n, hp, wp, _ = xp.shape
    cout = weight.shape[0]
    xk, packed, b, _, cpl, th = bf16_operands(xp, weight, bias, sms)
    h, w = hp - 6, wp - 6
    n_kc, n_cols = packed.shape[0] // 7, packed.shape[1]
    assert n_cols == (32 if cpl == 1 else 56)
    xk = F.pad(xk, (0, 64 * n_kc - xk.shape[3]))  # TMA's zero fill past C
    slabs = packed.reshape(n_kc, 7, n_cols, 64).float()
    cols = head_columns(cout, cpl)
    bias_k = torch.zeros(cout) if b is None else b
    units = head_walk(n, h, w, th, sms)
    assert len(set(units)) == len(units)  # every unit once
    y = torch.zeros((n, h, w, cout), dtype=xp.dtype)
    for i, y0, x0 in units:
        window = torch.zeros((7, HEAD_TW, cout))  # output rows r, r - 1, ..., r - 6
        for r in range(th + 6):
            box = _box(xk[i], torch.tensor([y0 + r]), torch.arange(HEAD_TW + 6) + x0)[0].float()
            u = sum(box[dx:dx + HEAD_TW, 64 * cb:64 * cb + 64] @ slabs[cb, dx].T
                    for cb in range(n_kc) for dx in range(7))  # (64, N)
            for dy in range(7):
                window[dy] += u[:, cols[dy]]
            if r >= 6 and y0 + r - 6 < h:
                nx = min(HEAD_TW, w - x0)
                y[i, y0 + r - 6, x0:x0 + nx] = (window[6] + bias_k).to(xp.dtype)[:nx]
            window = torch.cat([torch.zeros_like(window[:1]), window[:-1]])
    return y


def emulate(xp, weight, bias, sms=SMS):
    """conv7x7 the bf16 kernels' way, in xp's dtype."""
    fn = emulate_stem if xp.shape[3] <= 8 else emulate_head
    return fn(xp, weight, bias, sms)


def _data(n, h, w, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h + 6, w + 6, cin)).astype(np.float32)
    k = (rng.normal(size=(cout, cin, 7, 7)) / (49 * cin) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return (x, k, b), tuple(torch.from_numpy(t) for t in (x, k, b))


def _compare(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    g, r = got.float(), want.float()
    assert bool(((g - r).abs() <= tol * (1 + r.abs())).all()), float((g - r).abs().max())


# (n, h, w, Cin, Cout, sms), output sizes. The stem: every Cin / Cout pair
# on one tile touching all four edges (5 x 9) or on 2 x 2 ragged tiles
# (13 x 70); batch 2 with 12 x 10 = 120 tiles per image, more than the
# card's SMs (a block's walk crosses into the next image). The head: every
# Cout / C pair on units touching both edges (5 x 9, 13 x 70), and batch 2
# with more units than a 4-SM grid's 12 warpgroups, several rounds each.
STEM_SHAPES = ([(2, 5, 9, cin, cout, SMS) for cin in (1, 3, 8) for cout in (5, 64, 136)]
               + [(1, 13, 70, 3, 64, SMS), (1, 13, 70, 8, 136, SMS), (2, 90, 600, 3, 64, SMS)])
HEAD_SHAPES = ([(2, 5, 9, cin, cout, SMS) for cout in (1, 3, 8) for cin in (9, 64, 72)]
               + [(1, 13, 70, 64, 3, SMS), (1, 13, 70, 72, 8, SMS), (2, 21, 150, 64, 3, 4),
                  (2, 21, 150, 16, 6, 4)])
CASES = [(s, d) for s in STEM_SHAPES + HEAD_SHAPES for d in ("float32", "bfloat16")]


@pytest.mark.parametrize("shape,dtype", CASES, ids=[f"{s}-{d}" for s, d in CASES])
def test_conv7_tile_emulation_matches_plain(shape, dtype):
    n, h, w, cin, cout, sms = shape
    _, (x, k, b) = _data(n, h, w, cin, cout, seed=cin * 100 + cout + h)
    td = getattr(torch, dtype)
    args = (x.to(td), k.to(td), b)
    _compare(emulate(*args, sms=sms), conv7x7_plain(*args), dtype)


def test_conv7_tile_emulation_without_bias():
    for cin, cout in ((3, 64), (64, 3)):
        _, (x, k, _) = _data(1, 5, 9, cin, cout, seed=3)
        _compare(emulate(x, k, None), conv7x7_plain(x, k, None), "float32")


def test_head_rows_balance_the_grid():
    """The head's rows per unit: at the globe shape on 132 SMs one round of
    the 396 warpgroups (43 rows: 17 x 23 = 391 units); a unit never has
    more rows than the image."""
    from biasgan_tpu_torch.kernels.conv7x7 import head_rows

    assert head_rows(1, 724, 1440, SMS) == 43
    assert head_rows(1, 5, 9, SMS) <= 5
    th = head_rows(2, 256, 256, SMS)
    assert -(-2 * -(-256 // th) * 4 // (SMS * HEAD_NC)) == 1


@pytest.mark.parametrize("cin,cout", [(1, 5), (3, 64), (8, 136), (9, 1), (64, 3), (72, 8)])
def test_packs_hold_every_weight_once(cin, cout):
    """Every (tap, ci, co) of the weight lands in the pack exactly once and
    every other slot is zero: distinct values in, the same multiset out."""
    weight = torch.arange(1, cout * cin * 49 + 1, dtype=torch.float32).reshape(cout, cin, 7, 7)
    pack = pack_stem_weight if cin <= 8 else pack_head_weight
    packed = pack(weight)
    vals = packed[packed != 0]
    assert vals.numel() == weight.numel()
    assert torch.equal(vals.sort().values, weight.flatten())


# widths the JAX wrapper takes (it pads C to 8 and to its DMA's 128 lanes)
JAX_CASES = [((2, 5, 9, 3, 64), "float32"), ((1, 13, 70, 3, 16), "bfloat16"),
             ((2, 5, 9, 64, 3), "float32"), ((1, 13, 70, 72, 8), "bfloat16")]


@pytest.mark.parametrize("shape,dtype", JAX_CASES)
def test_conv7_tile_emulation_matches_pallas_interpret(shape, dtype):
    n, h, w, cin, cout = shape
    (xn, kn, bn), (x, k, b) = _data(n, h, w, cin, cout, seed=50 + cin)
    jd = getattr(jnp, dtype)
    yj = jax_conv7x7_valid(jnp.asarray(xn).astype(jd),
                           jnp.asarray(kn.transpose(2, 3, 1, 0)).astype(jd), jnp.asarray(bn),
                           interpret=True)
    td = getattr(torch, dtype)
    want = torch.from_numpy(np.array(yj.astype(jnp.float32))).to(td)
    _compare(emulate(x.to(td), k.to(td), b), want, dtype)

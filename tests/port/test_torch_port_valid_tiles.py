"""The VALID 3x3 conv (K6) as its bf16 CUDA kernel computes it
(biasgan_tpu_torch/kernels/csrc/conv3x3_valid.cu on conv3x3_tma.cuh's
conv_tma_kernel), emulated in torch on the CPU from the wrapper's own
pieces: ``bf16_operands`` (C, the bias and the residual zero-padded to
multiples of 8, the tile's couts from ``tile_geometry``, the weight packed
by ``pack_block_weight``, channel-transposed for the input gradient); the
persistent grid's walk over the tiles, cout blocks of a pixel tile next to
each other (the kernel's ``tile_of``); per tile of TH x TW pixels and
64-channel block, the (TH + 2) x (TW + 2) box of x with TMA's zero fill
past every edge, its origin the tile's own (VALID: the input carries its
pad on both axes) or two rows and columns up-left (the input gradient: the
kernel's zero pad of 2 on the unpadded cotangent); the nine taps against
their slabs, in order or, for the input gradient, reversed (slab 8 - t at
tap t); f32 accumulation; then the epilogue: f32 bias, the residual as TMA
loads it into the staging tile (zero past the image and past Cout), the
activation, one cast, stored clipped to the image.

The emulation is held to the wrapper's plain versions (which the CPU
takes: ``conv3x3_valid_plain``, ``conv3x3_valid_dx_plain``) over every
bias / residual / activation combination in f32 and bf16, on a tile that
touches both edges (C 12 and Cout 20, which the wrapper pads), one exact
tile with Cout 136, ragged multi-tile shapes with C 72 (two channel
blocks) on 128- and 256-cout tiles, and batch 2 with more tiles than the
card's 132 SMs; and to the JAX Pallas ``conv3x3_valid`` in interpret mode
and the input gradient of the JAX ``conv3x3_op`` (its VJP, which runs the
same Pallas kernel), with output widths that are multiples of 16, as the
JAX wrapper needs. The card holds the kernel to the plain versions
(test_torch_port_cuda.py, chip_smoke.py).

Tolerances: f32 1e-5, bf16 2e-2 (|d| <= tol (1 + |ref|)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from biasgan_tpu.ops.pallas_conv import conv3x3_op as jax_conv3x3_op
from biasgan_tpu.ops.pallas_conv import conv3x3_valid as jax_conv3x3_valid
from biasgan_tpu_torch.kernels.common import act_f32
from biasgan_tpu_torch.kernels.conv3x3_valid import (
    bf16_operands,
    conv3x3_valid_dx_plain,
    conv3x3_valid_plain,
)
from biasgan_tpu_torch.kernels.conv_tma import KW, TH, TW, pack_block_weight

EPILOGUES = [(bias, res, act) for bias in (False, True) for res in (False, True)
             for act in ("none", "relu", "lrelu")]


def walk(n, h, w, n_cb, sms):
    """The tiles (image, y0, x0, cout block) of the persistent grid, block
    by block, each block's in its walk order (the kernel's tile_of: t from
    the block's index in steps of the grid, cout block first)."""
    tiles_x, tiles_y = -(-w // TW), -(-h // TH)
    total = n * tiles_y * tiles_x * n_cb
    grid = min(total, sms)
    out = []
    for block in range(grid):
        for t in range(block, total, grid):
            p = t // n_cb
            out.append((p // (tiles_y * tiles_x), (p % (tiles_y * tiles_x)) // tiles_x * TH,
                        (p % tiles_x) * TW, t % n_cb))
    return out


def _tma(img, rows, cols):
    """What a TMA box of rows x cols (1-D index tensors) of one image
    (H, W, C) brings: zero outside the image."""
    h, w = img.shape[:2]
    z = F.pad(img, (0, 0, 0, 1, 0, 1))  # index h and w point at zeros
    r = torch.where((rows >= 0) & (rows < h), rows, h)
    q = torch.where((cols >= 0) & (cols < w), cols, w)
    return z[r][:, q]


def emulate(x, weight, bias, residual, act, bwd=False, sms=132):
    """conv3x3_valid (or with ``bwd`` conv3x3_valid_dx of the cotangent x)
    the bf16 kernel's way, in x's dtype (f32 or bf16), on a card of ``sms``
    SMs (which sets the tile's couts and the walk)."""
    n = x.shape[0]
    cout = weight.shape[1] if bwd else weight.shape[0]
    xk, packed, b, r, cout_k, bn = bf16_operands(x, weight, bias, residual, bwd, sms)
    off = -2 if bwd else 0  # the box origin's row and column against the tile's
    hin, win, c = xk.shape[1:]
    h, w = hin - 2 - 2 * off, win - 2 - 2 * off
    n_kc, cout_pad = -(-c // KW), packed.shape[1]
    xk = F.pad(xk, (0, n_kc * KW - c))  # TMA's zero fill of the channels past C
    tiles = walk(n, h, w, cout_pad // bn, sms)
    assert len(set(tiles)) == len(tiles)  # every tile once
    slabs = packed.reshape(n_kc, 9, cout_pad, KW)
    if bwd:
        slabs = slabs.flip(1)  # tap t reads slab 8 - t
    wk = slabs.permute(2, 0, 1, 3).reshape(cout_pad, -1).float()  # (Cout, (cb, tap, 64))
    bias_k = torch.zeros(cout_pad) if b is None else F.pad(b, (0, cout_pad - cout_k))
    y = torch.zeros((n, h, w, cout_k), dtype=x.dtype)
    rows, cols = torch.arange(TH), torch.arange(TW)
    for i, y0, x0, cb in tiles:
        co0 = cb * bn
        box = _tma(xk[i], torch.arange(TH + 2) + y0 + off, torch.arange(TW + 2) + x0 + off)
        taps = torch.stack([box[dy:dy + TH, dx:dx + TW] for dy in range(3) for dx in range(3)], 2)
        a = taps.reshape(TH * TW, 9, n_kc, KW).transpose(1, 2).reshape(TH * TW, -1).float()
        acc = a @ wk[co0:co0 + bn].T + bias_k[co0:co0 + bn]
        if r is not None:  # the staging tile as TMA loaded the residual
            acc = acc + F.pad(_tma(r[i], rows + y0, cols + x0), (0, cout_pad - cout_k))[
                ..., co0:co0 + bn].reshape(TH * TW, bn).float()
        tile = act_f32(acc, act).to(x.dtype).reshape(TH, TW, bn)
        ny, nx, nc = min(TH, h - y0), min(TW, w - x0), min(bn, cout_k - co0)
        y[i, y0:y0 + ny, x0:x0 + nx, co0:co0 + nc] = tile[:ny, :nx, :nc]
    return y[..., :cout]


def _data(n, h, w, c, cout, dtype, seed, bwd=False):
    """Inputs from a seed: x padded (N, H+2, W+2, C), or for the input
    gradient the cotangent (N, H, W, Cout); the OIHW weight; the bias; the
    residual (N, H, W, Cout)."""
    rng = np.random.default_rng(seed)
    shape = (n, h, w, cout) if bwd else (n, h + 2, w + 2, c)
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(cout, c, 3, 3)) / (9 * c) ** 0.5).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    r = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    td = getattr(torch, dtype)
    return (x, k, b, r), tuple(torch.from_numpy(t) for t in (x, k, b, r)), td


def _compare(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    g, r = got.float(), want.float()
    assert bool(((g - r).abs() <= tol * (1 + r.abs())).all()), float((g - r).abs().max())


# (n, h, w, C, Cout, sms), output sizes: one tile touching both edges (C 12
# and Cout 20 padded by the wrapper); one exact 7 x 18 tile, Cout 136; three
# ragged tiles across and two down, C 72 in two channel blocks, Cout 136 on
# two 128-cout tiles (the picker's choice at 132 SMs) or one 256-cout tile
# (at 4 SMs); batch 2 with 117 tiles per image, more than the card's SMs (a
# block's walk crosses into the next image)
SHAPES = [(2, 5, 9, 12, 20, 132), (1, 7, 18, 64, 136, 132), (1, 13, 37, 72, 136, 132),
          (1, 13, 37, 72, 136, 4), (2, 90, 150, 16, 24, 132)]
PLAIN_CASES = ([(0, e, d) for e in range(len(EPILOGUES)) for d in ("float32", "bfloat16")]
               + [(s, (5 * s + j) % len(EPILOGUES), d) for s in range(1, len(SHAPES))
                  for j in range(3) for d in ("float32", "bfloat16")])


@pytest.mark.parametrize("shape,epilogue,dtype", PLAIN_CASES)
def test_valid_tile_emulation_matches_plain(shape, epilogue, dtype):
    n, h, w, c, cout, sms = SHAPES[shape]
    bias, res, act = EPILOGUES[epilogue]
    _, (x, k, b, r), td = _data(n, h, w, c, cout, dtype, seed=shape + 10 * epilogue)
    args = (x.to(td), k.to(td), b if bias else None, r.to(td) if res else None, act)
    _compare(emulate(*args, sms=sms), conv3x3_valid_plain(*args), dtype)


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_grad_emulation_matches_plain(shape, dtype):
    """The input gradient: the unpadded cotangent, the box two rows and
    columns up-left with TMA's zero fill, the transposed pack read in
    reverse, against the plain version (pad by 2, flipped and transposed
    weight)."""
    n, h, w, c, cout, sms = SHAPES[shape]
    _, (g, k, _, _), td = _data(n, h, w, c, cout, dtype, seed=40 + shape, bwd=True)
    g, k = g.to(td), k.to(td)
    _compare(emulate(g, k, None, None, "none", bwd=True, sms=sms),
             conv3x3_valid_dx_plain(g, k), dtype)


# output widths that are multiples of 16 (the JAX wrapper's alignment): 5 x
# 16 is one tile touching both edges; 13 x 32 two tiles across and two down
JAX_SHAPES = [(2, 5, 16, 8, 8), (1, 13, 32, 16, 24)]
JAX_CASES = [(0, 0, "float32"), (0, 11, "bfloat16"), (0, 4, "float32"), (0, 9, "bfloat16"),
             (1, 7, "bfloat16"), (1, 2, "float32")]


@pytest.mark.parametrize("shape,epilogue,dtype", JAX_CASES)
def test_valid_tile_emulation_matches_pallas_interpret(shape, epilogue, dtype):
    n, h, w, c, cout = JAX_SHAPES[shape]
    bias, res, act = EPILOGUES[epilogue]
    (xn, kn, bn, rn), (x, k, b, r), td = _data(n, h, w, c, cout, dtype, seed=60 + epilogue)
    jd = getattr(jnp, dtype)
    yj = jax_conv3x3_valid(jnp.asarray(xn).astype(jd),
                           jnp.asarray(kn.transpose(2, 3, 1, 0)).astype(jd),
                           jnp.asarray(bn) if bias else None,
                           jnp.asarray(rn).astype(jd) if res else None, act, interpret=True)
    want = torch.from_numpy(np.array(yj.astype(jnp.float32))).to(td)
    got = emulate(x.to(td), k.to(td), b if bias else None, r.to(td) if res else None, act)
    _compare(got, want, dtype)


@pytest.mark.parametrize("shape,dtype", [(0, "float32"), (0, "bfloat16"), (1, "bfloat16")])
def test_input_grad_emulation_matches_jax_vjp(shape, dtype):
    """dxp of the JAX conv3x3_op's VJP (the Pallas kernel on the 2-padded
    cotangent in interpret mode) against the emulated input gradient."""
    n, h, w, c, cout = JAX_SHAPES[shape]
    (xn, kn, _, _), (_, k, _, _), td = _data(n, h, w, c, cout, dtype, seed=80 + shape)
    gn = np.random.default_rng(90 + shape).normal(size=(n, h, w, cout)).astype(np.float32)
    jd = getattr(jnp, dtype)
    kj = jnp.asarray(kn.transpose(2, 3, 1, 0)).astype(jd)
    _, vjp = jax.vjp(lambda xp: jax_conv3x3_op(xp, kj, None, True), jnp.asarray(xn).astype(jd))
    (dxp,) = vjp(jnp.asarray(gn).astype(jd))
    want = torch.from_numpy(np.array(dxp.astype(jnp.float32))).to(td)
    got = emulate(torch.from_numpy(gn).to(td), k.to(td), None, None, "none", bwd=True)
    _compare(got, want, dtype)


@pytest.mark.parametrize("n,h,w,n_cb,sms,tiles", [
    (2, 64, 64, 1, 132, 80),  # training forward, B 2: one round
    (3, 66, 66, 1, 132, 120),  # the input gradient's output, B 3: one round
    (1, 181, 360, 1, 132, 520),  # the globe block shape: four rounds
    (2, 90, 150, 2, 132, 468),  # across images, two cout blocks
])
def test_tile_walk_covers_every_tile_once(n, h, w, n_cb, sms, tiles):
    """The persistent grid's walk: every (image, tile, cout block) once,
    the shapes' tile counts the kernel's header reckons (40 per image at
    the training forward and input gradient, 520 at the globe)."""
    got = walk(n, h, w, n_cb, sms)
    assert len(got) == len(set(got)) == tiles
    assert {t[0] for t in got} == set(range(n)) and {t[3] for t in got} == set(range(n_cb))


@pytest.mark.parametrize("c,cout,bn", [(12, 20, 128), (72, 136, 128), (256, 256, 256)])
def test_input_grad_pack_is_the_flipped_transposed_pack(c, cout, bn):
    """The input gradient's pack (the forward's OIHW weight as an IOHW
    view, one copy) holds at slab t what the pack of the flipped,
    channel-transposed weight holds at slab 8 - t: the kernel's reversed
    taps make the flip."""
    idx = torch.arange(1, cout * c * 9 + 1, dtype=torch.float32).reshape(cout, c, 3, 3)
    packed = pack_block_weight(idx.transpose(0, 1), bn)
    ref = pack_block_weight(idx.flip(2, 3).transpose(0, 1), bn)
    n_kc = -(-cout // KW)
    assert packed.is_contiguous() and packed.shape == ref.shape
    assert torch.equal(packed.reshape(n_kc, 9, -1, KW), ref.reshape(n_kc, 9, -1, KW).flip(1))

"""The stride-2 conv-transpose as its bf16 CUDA kernel computes it
(biasgan_tpu_torch/kernels/csrc/convt3x3s2_fused.cu, up_tma_kernel),
emulated in torch on the CPU from the wrapper's own pieces: the operands of
``bf16_operands`` (C and Cout padded to multiples of 8, the weight packed
by ``pack_up_weight`` in the slab order of ``SLABS``, a and b zero past C),
units of TH x TW input pixels by BN couts walked by a persistent grid
(cout block first, then tile, then image, block b taking units b, b + G,
...), per channel block a box of the tile, its bottom row and right column
with TMA's zero fill past every edge and channel, the wrap column from
input column 0 in a side box, the prologue on real values only (a
zero-filled position stays zero, never act(b)), the four shifted A views
onto their accumulator ranges [ee | eo | oo | oe], f32 accumulation from
the bias, one cast, the phases interleaved in the staging tile, and the moments of
the stored value summed per unit into each block's slot, the slots then
summed in order.

The emulation is held to the wrapper's plain version (which the CPU takes)
and to the JAX Pallas kernel plus ``interleave_phases`` in interpret mode,
as test_torch_port_updown.py runs them. The card holds the kernel to the
plain version (test_torch_port_cuda.py, chip_smoke.py).

Tolerances (test_torch_port_updown.py's): y within f32 1e-4, bf16 2e-2
(|d| <= tol (1 + |ref|)); moments in f32 within 1e-4 relative, and in both
dtypes no further from the reference's than the stored outputs are, plus
1e-5 of summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_conv import FusedBlockPlan
from biasgan_tpu.ops.pallas_conv import convt3x3s2_fused as jax_up
from biasgan_tpu.ops.pallas_conv import interleave_phases
from biasgan_tpu_torch.kernels.common import affine_act
from biasgan_tpu_torch.kernels.convt3x3s2_fused import (
    BN,
    KW,
    PHASES,
    SLABS,
    TH,
    TW,
    _packed_weight,
    bf16_operands,
    convt3x3s2_fused_plain,
    pack_up_weight,
)

GRID = 3  # blocks of the emulated persistent grid: walks cross images and cout blocks


def emulate(x, weight, bias, prologue, act, w_mode, grid=GRID):
    """convt3x3s2_fused the bf16 kernel's way, in x's dtype (f32 or bf16)."""
    cout = weight.shape[1]
    x, packed, bias, prologue, cout_k = bf16_operands(x, weight, bias, prologue)
    n, h, w, c = x.shape
    n_kc, n_cob = -(-c // KW), -(-cout_k // BN)
    assert packed.shape == (n_cob * n_kc * 9 * BN, KW)
    assert torch.equal(packed, pack_up_weight(weight.to(x.dtype)))  # the pads change no slab
    tiles_y, tiles_x = -(-h // TH), -(-w // TW)
    # every position a box can reach (the tile, its bottom row and right
    # column, 64-channel blocks): x where it lies in the input, TMA's zero
    # fill elsewhere; the prologue on the real positions only
    hb, wb = tiles_y * TH + 1, tiles_x * TW + 1
    src = torch.zeros((n, hb, wb, n_kc * KW), dtype=x.dtype)
    src[:, :h, :w, :c] = x
    side = torch.zeros((n, hb, n_kc * KW), dtype=x.dtype)  # the wrap column: input column 0
    side[:, :h, :c] = x[:, :, 0]
    if prologue is not None:
        a, b = prologue  # (N, 64 n_kc), zero past C
        real = torch.zeros((1, hb, wb, 1), dtype=torch.bool)
        real[:, :h, :w] = True
        src = torch.where(real, affine_act(src, a, b, act), torch.zeros((), dtype=x.dtype))
        side_real = (torch.arange(hb) < h)[None, :, None]
        side = torch.where(side_real, affine_act(side[:, :, None], a, b, act)[:, :, 0],
                           torch.zeros((), dtype=x.dtype))
    y = torch.zeros((n, 2 * h, 2 * w, cout_k), dtype=x.dtype)
    slots = torch.zeros((grid, 2, n, cout_k))  # each block's moment slot
    units = n * tiles_y * tiles_x * n_cob
    ty, tx = torch.arange(TH)[:, None], torch.arange(TW)[None, :]
    for t in range(units):
        cob, p = t % n_cob, t // n_cob
        i, sp = p // (tiles_y * tiles_x), p % (tiles_y * tiles_x)
        y0, x0, co0 = (sp // tiles_x) * TH, (sp % tiles_x) * TW, cob * BN
        # the accumulators start at the f32 bias of their couts, every phase
        bias_u = torch.zeros(BN)
        if bias is not None:
            got = bias[co0:co0 + BN]
            bias_u[:got.shape[0]] = got
        acc = bias_u.repeat(4).expand(TH, TW, 4 * BN).clone()
        for cb in range(n_kc):
            box = src[i, y0:y0 + TH + 1, x0:x0 + TW + 1, cb * KW:(cb + 1) * KW]
            row = (cob * n_kc + cb) * 9 * BN
            for (sy, sx), blocks in SLABS:
                a_view = box[sy:sy + TH, sx:sx + TW]
                if w_mode == "wrap":  # a lane whose pixel is column W reads the side box
                    on_side = (x0 + tx + sx == w).expand(TH, TW)
                    a_view = torch.where(on_side[..., None],
                                         side[i, y0 + sy:y0 + sy + TH, None, cb * KW:(cb + 1) * KW],
                                         a_view)
                rows = len(blocks) * BN
                slab = packed[row:row + rows].float()
                first = blocks[0][1] * BN
                assert [ph for _, ph in blocks] == list(range(blocks[0][1], blocks[0][1] + len(blocks)))
                acc[..., first:first + rows] += a_view.float() @ slab.T
                row += rows
        # epilogue: one cast, the phases interleaved into the staging tile
        # (2 TH x 2 TW output pixels by BN couts), stored clipped
        vals = acc.reshape(TH, TW, 4, BN).to(x.dtype)
        stage = torch.zeros((TH, 2, TW, 2, BN), dtype=x.dtype)
        for ph, (py, px) in enumerate(PHASES):
            stage[:, py, :, px] = vals[:, :, ph]
        stage = stage.reshape(2 * TH, 2 * TW, BN)
        ny, nx = 2 * min(TH, h - y0), 2 * min(TW, w - x0)
        nc = min(BN, cout_k - co0)
        real = stage[:ny, :nx, :nc]
        y[i, 2 * y0:2 * y0 + ny, 2 * x0:2 * x0 + nx, co0:co0 + nc] = real
        sums = torch.stack([real.float().sum((0, 1)), real.float().square().sum((0, 1))])
        slots[t % grid, :, i, co0:co0 + nc] += sums
    moments = slots.sum(0)
    return y[..., :cout], (moments[0, :, :cout], moments[1, :, :cout])


def _data(n, h, w, c, cout, dtype, seed, prologue):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(c, cout, 3, 3)) / (9 * c) ** 0.5).astype(np.float32)  # IOHW
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
    tol = 1e-4 if dtype == "float32" else 2e-2
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


# (N, H, W, C, Cout): one tile touching all four edges at batch 2 with C 12
# and Cout 20 padded; two rows of three tiles, the last ragged, and three
# cout blocks, the last ragged (Cout 136); W narrower than a tile with two
# channel blocks at batch 2, the grid's walk crossing into the next image
SHAPES = [(2, 5, 9, 12, 20), (1, 13, 40, 64, 136), (2, 9, 16, 128, 64)]
CASES = [(s, d, w, p) for s in SHAPES for d in ("float32", "bfloat16")
         for w in ("wrap", "zero") for p in (False, True)]


@pytest.mark.parametrize("shape,dtype,w_mode,prologue", CASES)
def test_up_tile_emulation_matches_plain(shape, dtype, w_mode, prologue):
    _, (x, k, b, pro) = _data(*shape, dtype, seed=sum(shape) + len(dtype) + prologue,
                              prologue=prologue)
    args = (x, k, b, pro, "relu", w_mode)
    _compare(emulate(*args), convt3x3s2_fused_plain(*args), dtype)


H_IN = 13  # the JAX plan's last tile holds one row, as in test_torch_port_updown.py
PLAN = FusedBlockPlan(H_IN, 2, 14, True)
JAX_CASES = [(d, w, p) for d in ("float32", "bfloat16") for w in ("wrap", "zero")
             for p in (False, True)]


@pytest.mark.parametrize("dtype,w_mode,prologue", JAX_CASES)
def test_up_tile_emulation_matches_pallas_interpret(dtype, w_mode, prologue):
    """Input 13 x 16, C 8, Cout 16 (the Pallas plan needs W % 8 == 0): the
    port's tiles are ragged on both axes there (7 x 18 input pixels)."""
    n, c, cout = 2, 8, 16
    (xn, kn, bn, pron), (x, k, b, pro) = _data(
        n, H_IN, 16, c, cout, dtype, seed=60 + len(dtype) + prologue, prologue=prologue)
    jd = getattr(jnp, dtype)
    xj = jnp.asarray(xn).astype(jd)
    tail = jnp.full((n, PLAN.h_run - H_IN, 16, c), 7.75, jd)  # never read
    phases, (s, q) = jax_up(
        jnp.concatenate([xj, tail], axis=1), jnp.asarray(kn.transpose(2, 3, 0, 1)).astype(jd),
        jnp.asarray(bn), prologue=None if pron is None else tuple(map(jnp.asarray, pron)),
        act_pre="relu", plan=PLAN, w_mode=w_mode, want_moments=True,
    )
    y = interleave_phases(phases, H_IN)
    want = (torch.from_numpy(np.array(y.astype(jnp.float32))).to(x.dtype),
            (torch.from_numpy(np.array(s)), torch.from_numpy(np.array(q))))
    _compare(emulate(x, k, b, pro, "relu", w_mode), want, dtype)


@pytest.mark.parametrize("c,cout", [(8, 16), (72, 136)])
def test_packed_weight_holds_every_tap_once(c, cout):
    """Packed indices: each (c, cout, ky, kx) of the IOHW weight lands once,
    in the 64-row block of its tap in SLABS order, at (cout block, channel
    block); the rest is zero. The wrapper's gather packs the same."""
    idx = torch.arange(1, c * cout * 9 + 1).reshape(c, cout, 3, 3)
    packed = pack_up_weight(idx)
    n_kc, n_cob = -(-c // KW), -(-cout // BN)
    assert packed.shape == (n_cob * n_kc * 9 * BN, KW)
    hits = packed[packed > 0]
    assert torch.equal(hits.sort().values, idx.flatten())
    taps = [tap for _, blocks in SLABS for tap, _ in blocks]
    assert sorted(taps) == [(ky, kx) for ky in range(3) for kx in range(3)]
    blocks = packed.view(n_cob, n_kc, 9, BN, KW)
    for q, (ky, kx) in enumerate(taps):
        want = torch.zeros((n_kc * KW, n_cob * BN), dtype=idx.dtype)
        want[:c, :cout] = idx[:, :, ky, kx]
        got = blocks[:, :, q].permute(1, 3, 0, 2).reshape(n_kc * KW, n_cob * BN)
        assert torch.equal(got, want)
    w = torch.randn(c, cout, 3, 3)
    assert torch.equal(_packed_weight(w, torch.float32), pack_up_weight(w))

"""The stride-2 down conv as its bf16 CUDA kernel computes it
(biasgan_tpu_torch/kernels/csrc/conv3x3s2_fused.cu, down_tma_kernel),
emulated in torch on the CPU from the wrapper's own pieces: C padded to a
multiple of 8 (``pad_channels``), the phase view (N, H/2, 2, W/2, 2C),
the k-blocks of ``phase_k_blocks`` against the B operand that
``pack_phase_weight`` packs, tiles of ``tile_geometry`` with TMA's zero
fill past every edge (the top pad row, the zero W pad, the ragged right
tile, channels past 2C), the wrap column of output column 0 from
pair column W/2 - 1, the prologue on real values only (a zero-filled
position stays zero, never act(b)), f32 accumulation, bias, one cast, and
the moments of the stored value summed tile by tile.

The emulation is held to the wrapper's plain version (which the CPU takes)
and to the JAX Pallas kernel in interpret mode, as
test_torch_port_updown.py runs it. The card holds the kernel to the plain
version (test_torch_port_cuda.py, chip_smoke.py).

Tolerances: y within f32 1e-5, bf16 2e-2 (|d| <= tol (1 + |ref|)); moments
in f32 within 1e-4 relative, and in both dtypes no further from the
reference's than the stored outputs are, plus 1e-5 of summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biasgan_tpu.ops.pallas_conv import FusedBlockPlan
from biasgan_tpu.ops.pallas_conv import conv3x3s2_fused as jax_down
from biasgan_tpu_torch.kernels.common import affine_act, pad_channels
from biasgan_tpu_torch.kernels.conv3x3s2_fused import (
    KW,
    _packed_weight,
    conv3x3s2_fused_plain,
    pack_phase_weight,
    phase_k_blocks,
    tile_geometry,
)


def emulate(x, weight, bias, prologue, act, w_mode):
    """conv3x3s2_fused the bf16 kernel's way, in x's dtype (f32 or bf16)."""
    x, weight, prologue = pad_channels(x, weight, prologue)
    n, h, w, c = x.shape
    ho, wo, cout = h // 2, w // 2, weight.shape[0]
    bn, bw, bh = tile_geometry(cout)
    ht, wt = -(-ho // bh), -(-wo // bw)
    kc = -(-2 * c // KW) * KW  # merged channels the k-blocks cover
    # every position a box can reach: pair rows -1 .. ht bh - 1, pair
    # columns -1 .. wt bw - 1; what lies outside x is TMA's zero fill
    src = torch.zeros((n, ht * bh + 1, 2, wt * bw + 1, kc), dtype=x.dtype)
    real = torch.zeros((n, ht * bh + 1, 2, wt * bw + 1, 1), dtype=torch.bool)
    xv = x.reshape(n, ho, 2, wo, 2 * c)  # the phase view: no copy
    src[:, 1:ho + 1, :, 1:wo + 1, :2 * c] = xv
    real[:, 1:ho + 1, :, 1:wo + 1] = True
    if w_mode == "wrap":  # pair column -1 is only read at output column 0
        src[:, 1:ho + 1, :, 0, :2 * c] = xv[:, :, :, wo - 1]
        real[:, 1:ho + 1, :, 0] = True
    if prologue is not None:
        a, b = (torch.cat([t, t], 1) for t in prologue)  # per merged channel
        a, b = (torch.nn.functional.pad(t, (0, kc - 2 * c)) for t in (a, b))
        flat = src.reshape(n, -1, 2 * (wt * bw + 1), kc)
        t = affine_act(flat, a, b, act).reshape(src.shape)
        chan = (torch.arange(kc) < 2 * c)
        src = torch.where(real & chan, t, src)
    packed = pack_phase_weight(weight.to(x.dtype), bn)
    assert torch.equal(packed, _packed_weight(weight, x.dtype))
    acc = torch.zeros((n, ht * bh, wt * bw, packed.shape[1]))
    for kb, (dy, off, cb) in enumerate(phase_k_blocks(c)):
        plane, row0 = (0, 1) if dy == 1 else (1, dy // 2)
        box = src[:, row0:row0 + ht * bh, plane, 1 + off:1 + off + wt * bw,
                  cb * KW:(cb + 1) * KW]
        acc += box.float() @ packed[kb].float().T
    acc = acc[..., :cout]
    if bias is not None:
        acc = acc + bias.float()
    y = acc.to(x.dtype)
    # moments of the stored value, per tile, then summed over the tiles
    inside = torch.zeros((ht * bh, wt * bw, 1), dtype=torch.bool)
    inside[:ho, :wo] = True
    yf = torch.where(inside, y.float(), torch.zeros(()))
    tiles = yf.reshape(n, ht, bh, wt, bw, cout)
    sums = tiles.sum(dim=(2, 4)).reshape(n, -1, cout).sum(1)
    sqs = tiles.square().sum(dim=(2, 4)).reshape(n, -1, cout).sum(1)
    return y[:, :ho, :wo], (sums, sqs)


def _data(n, h, w, c, cout, dtype, seed, prologue):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
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


# (C, Cout) -> output 13 x 136: two tiles across each pair row, the second
# ragged (BW 128); C 3 takes the padded route
SHAPES = {3: 5, 8: 16, 64: 128, 128: 256}
CASES = [(c, d, w, p) for c in SHAPES for d in ("float32", "bfloat16")
         for w in ("wrap", "zero") for p in (False, True)]


@pytest.mark.parametrize("c,dtype,w_mode,prologue", CASES)
def test_phase_view_emulation_matches_plain(c, dtype, w_mode, prologue):
    _, (x, k, b, pro) = _data(2, 26, 272, c, SHAPES[c], dtype, seed=c + len(dtype) + prologue,
                              prologue=prologue)
    args = (x, k, b, pro, "relu", w_mode)
    _compare(emulate(*args), conv3x3s2_fused_plain(*args), dtype)


JAX_SHAPES = {8: 16, 64: 128, 128: 256}
H_OUT = 13  # the JAX plan's last tile holds one row, as in test_torch_port_updown.py
PLAN = FusedBlockPlan(H_OUT, 2, 14, True)
JAX_CASES = [(c, d, w, p) for c in JAX_SHAPES for d in ("float32", "bfloat16")
             for w in ("wrap", "zero") for p in (False, True)]


@pytest.mark.parametrize("c,dtype,w_mode,prologue", JAX_CASES)
def test_phase_view_emulation_matches_pallas_interpret(c, dtype, w_mode, prologue):
    """W 32: the Pallas plan needs (W/2) % 8 == 0; the port's tile is still
    ragged there (16 of 128 columns)."""
    (xn, kn, bn, pron), (x, k, b, pro) = _data(
        2, 2 * H_OUT, 32, c, JAX_SHAPES[c], dtype, seed=50 + c + prologue, prologue=prologue)
    jd = getattr(jnp, dtype)
    y, (s, q) = jax_down(
        jnp.asarray(xn).astype(jd), jnp.asarray(kn.transpose(2, 3, 1, 0)).astype(jd),
        jnp.asarray(bn), prologue=None if pron is None else tuple(map(jnp.asarray, pron)),
        act_pre="relu", plan=PLAN, w_mode=w_mode, want_moments=True,
    )
    want = (torch.from_numpy(np.array(y.astype(jnp.float32))).to(x.dtype),
            (torch.from_numpy(np.array(s)), torch.from_numpy(np.array(q))))
    _compare(emulate(x, k, b, pro, "relu", w_mode), want, dtype)


@pytest.mark.parametrize("c", [8, 24, 64, 96, 128, 256])
def test_packed_weight_holds_every_tap_once(c):
    """Packed indices: each (cout, c, dy, dx) of the OIHW weight lands once,
    in the slab of its row tap and pair-column offset, the rest is zero."""
    cout = 24
    bn = tile_geometry(cout)[0]
    idx = torch.arange(1, cout * c * 9 + 1).reshape(cout, c, 3, 3)
    packed = pack_phase_weight(idx, bn)
    blocks = phase_k_blocks(c)
    assert packed.shape == (len(blocks), bn, KW)
    assert torch.equal(packed[:, cout:], torch.zeros_like(packed[:, cout:]))
    hits = packed[packed > 0]
    assert torch.equal(hits.sort().values, idx.flatten())
    for kb, (dy, off, cb) in enumerate(blocks):
        for j in range(KW):
            cm = cb * KW + j  # merged channel
            col = packed[kb, :cout, j]
            if cm >= 2 * c or (off == -1 and cm < c):
                assert not col.any()
            else:
                dx = 0 if off == -1 else (1 if cm < c else 2)
                assert torch.equal(col, idx[:, cm % c, dy, dx])

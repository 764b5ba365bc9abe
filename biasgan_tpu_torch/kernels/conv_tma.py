"""Host side of the TMA / wgmma tile loop of the 3x3 stride-1 convs
(csrc/conv3x3_tma.cuh), which the block conv (K1, ``conv3x3_fused``) and
the VALID conv (K6, ``conv3x3_valid``, forward and input gradient) both
launch: the tile's shape, the choice of its couts per call, and the weight
packed into the kernel's K-major slabs.

The wrappers call ``tile_geometry`` through this module, so one
assignment here fixes the width for both (``profile_block_conv``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

KW = 64  # input channels per channel block of the kernel (one 128-byte row)
TH, TW = 7, 18  # output rows and columns of the kernel's tile (126 pixels)
# a 128-cout tile's time against a 256-cout one's on the card: half the
# products, the same box and A fragments (measured on K1 by
# profile_block_conv)
HALF_TILE_COST = 0.65


def tile_geometry(n: int, h: int, w: int, cout: int, sms: int) -> int:
    """The couts of the kernel's tile for output (n, h, w, cout) on a
    card of ``sms`` SMs (a persistent grid of one block per SM): 128 for
    Cout <= 128, else 256 unless 128-cout tiles take fewer rounds of the
    grid at HALF_TILE_COST each (one round: every block takes a tile)."""
    if cout <= 128:
        return 128
    pixel_tiles = n * -(-h // TH) * -(-w // TW)

    def rounds(bn):
        return -(-pixel_tiles * -(-cout // bn) // sms)

    return 128 if HALF_TILE_COST * rounds(128) < rounds(256) else 256


def pack_block_weight(
    weight: torch.Tensor, bn: int, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """OIHW ``weight`` (Cout, C, 3, 3) as the kernel's B:
    (9 n_kc, Cout rounded up to ``bn``, 64), n_kc = C / 64 rounded up, slab
    9 cb + 3 dy + dx the K-major tap matrix W[:, 64 cb .. 64 cb + 63, dy,
    dx], zero past C and past Cout, in ``dtype`` (the weight's by default):
    one copy (with a pad where C or Cout falls short). A strided view
    packs in the same one copy: the input gradient's channel-transposed
    weight is ``weight.transpose(0, 1)``."""
    cout, cin = weight.shape[:2]
    n_kc, cout_pad = -(-cin // KW), -(-cout // bn) * bn
    if n_kc * KW != cin or cout_pad != cout:
        weight = F.pad(weight, (0, 0, 0, 0, 0, n_kc * KW - cin, 0, cout_pad - cout))
    view = weight.reshape(cout_pad, n_kc, KW, 9).permute(1, 3, 0, 2)
    out = torch.empty(view.shape, dtype=dtype or weight.dtype, device=weight.device)
    return out.copy_(view).view(9 * n_kc, cout_pad, KW)

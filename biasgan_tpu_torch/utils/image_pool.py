"""The reference's 50-slot replay buffer of generated images (ImagePool).

Counterpart of ``biasgan_tpu/utils/image_pool.py`` (``pool_query`` :43),
with its semantics per incoming image, sequential over the batch:

* while the pool is not full: store the image, return it;
* once full: with p = 0.5 return a randomly chosen stored image and put the
  new one in its slot, else return the new image.

The buffer and its fill count are tensors on the training device, kept in
the train state and checkpointed with it. The random decisions come from an
explicit ``torch.Generator``, or are passed in (``draws``), so that a test
can hand both packages the same decisions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass
class PoolState:
    buffer: torch.Tensor  # (pool_size, H, W, C)
    count: int  # slots filled so far


def create_pool(pool_size: int, shape, device=None, dtype=torch.float32) -> PoolState:
    return PoolState(torch.zeros((pool_size,) + tuple(shape), dtype=dtype, device=device), 0)


def pool_draws(n: int, pool_size: int, generator: Optional[torch.Generator]):
    """One (coin, index) pair per image: coin uniform in [0, 1), index
    uniform in [0, pool_size)."""
    coins = torch.rand(n, generator=generator).tolist()
    idx = torch.randint(0, max(pool_size, 1), (n,), generator=generator).tolist()
    return list(zip(coins, idx))


def pool_query(
    pool: PoolState,
    images: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[Tuple[float, int]]] = None,
) -> Tuple[PoolState, torch.Tensor]:
    """Query a batch of images through the pool; returns (new pool, out).
    The pool's buffer is updated in place (the state is the caller's own);
    ``draws`` gives each image's (coin, index), else ``generator`` draws
    them."""
    p = pool.buffer.shape[0]
    if p == 0:
        return pool, images
    if draws is None:
        draws = pool_draws(images.shape[0], p, generator)
    buffer, count = pool.buffer, pool.count
    outs = []
    for img, (coin, rand_idx) in zip(images, draws):
        if count < p:
            buffer[count] = img
            count += 1
            outs.append(img)
        elif coin > 0.5:
            outs.append(buffer[rand_idx].clone())
            buffer[rand_idx] = img
        else:
            outs.append(img)
    return PoolState(buffer, count), torch.stack(outs)

"""Row padding of the splat axis.

Padded rows sit at the far-away sentinel ``PAD_POS``, so every distance to
them is invalid and they sort after every real point.  The SOR kernel pads
N to a multiple of its 512-point block; ``next_pow2`` keeps the size rule
by which the JAX package picks its SOR route and its small-N block.
"""

from __future__ import annotations

import torch

PAD_POS = 1e15  # far-away sentinel coordinate for padded points


def next_pow2(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_rows(a: torch.Tensor, size: int, fill: float = 0.0) -> torch.Tensor:
    n = a.shape[0]
    if n == size:
        return a
    pad = torch.full((size - n,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=0)

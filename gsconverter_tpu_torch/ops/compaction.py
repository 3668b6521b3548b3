"""Compaction of masked splats where the cloud's tensors live.

A stable sort of the inverted keep-mask moves the survivors to the front in
their order; only the survivor count crosses to the host, where it sizes
the final slice of every leaf.  The heavy rows are gathered once, on the
cloud's device, instead of round-tripping through numpy boolean indexing.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from ..cloud import SplatCloud


def _front_pack_order(mask: torch.Tensor):
    """Stable order placing kept rows first, and the survivor count."""
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    return order, mask.sum()


def compact(cloud: SplatCloud, mask: torch.Tensor) -> SplatCloud:
    """A new cloud with only the mask=True splats (gathered on the device):
    ``SplatCloud.compact`` of a tensor cloud.  The count is the one scalar
    read back."""
    mask = torch.as_tensor(mask, device=cloud.pos.device)
    order, count = _front_pack_order(mask)
    n_keep = int(count)
    return cloud.select(order[:n_keep])

"""SplatCloud sharding: pad the splat axis and take this rank's rows.

All filters are element-wise masks over the N axis, so data parallelism is
a split of N; cross-shard compute (SOR halos, K-Means reductions) lives in
``parallel/distributed.py``.  Each rank holds the whole (replicated) cloud,
so taking a shard is a slice: rank r's rows are the rows the JAX package
places on device r.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud import SplatCloud
from .mesh import Mesh


def _pad_leaf(a, pad: int, fill: float = 0.0):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])
    a = np.asarray(a)
    return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)])


def pad_cloud(cloud: SplatCloud, multiple: int) -> tuple[SplatCloud, int]:
    """Pad N to a multiple with far-away zero-opacity splats; returns (cloud, valid_n).

    Padding splats lie beyond any real data (every coordinate at
    ``max|pos| * 2 + 1e6``) so spatial filters ignore them, with opacity
    logit -30 (alpha ~ 0) so rendering ignores them too, and the identity
    rotation [1, 0, 0, 0].
    """
    n = cloud.n
    pad = (-n) % multiple
    if pad == 0:
        return cloud, n
    if isinstance(cloud.pos, torch.Tensor):
        top = float(cloud.pos.abs().max()) if n else 0.0
    else:
        top = float(np.abs(np.asarray(cloud.pos)).max()) if n else 0.0
    far = float(np.float32(top) * np.float32(2) + np.float32(1e6))  # in f32, as JAX
    quat = _pad_leaf(cloud.quat, pad)
    quat[n:, 0] = 1.0
    return (
        cloud.replace(
            pos=_pad_leaf(cloud.pos, pad, far),
            sh_dc=_pad_leaf(cloud.sh_dc, pad),
            sh_rest=_pad_leaf(cloud.sh_rest, pad),
            opacity=_pad_leaf(cloud.opacity, pad, -30.0),
            log_scale=_pad_leaf(cloud.log_scale, pad),
            quat=quat,
            normal=_pad_leaf(cloud.normal, pad),
            rgb=_pad_leaf(cloud.rgb, pad),
            extras={k: _pad_leaf(v, pad) for k, v in cloud.extras.items()},
        ),
        n,
    )


def _rows(cloud: SplatCloud, lo: int, hi: int, device) -> SplatCloud:
    named = {name: None if a is None else a[lo:hi]
             for name, a in cloud._named_leaves().items()}
    return cloud._rebuild(named).to_device(device)


def place_cloud(cloud: SplatCloud, mesh: Mesh) -> SplatCloud:
    """This rank's rows WITHOUT padding, as tensors on ``mesh.device``, in
    GSPMD's uneven split: shards of ceil(N / size) rows, the last ones
    shorter (or empty)."""
    per = -(-cloud.n // mesh.size)
    lo = min(mesh.rank * per, cloud.n)
    return _rows(cloud, lo, min(lo + per, cloud.n), mesh.device)


def shard_cloud(cloud: SplatCloud, mesh: Mesh) -> tuple[SplatCloud, int]:
    """Pad to the mesh size; returns (this rank's rows of the padded cloud
    as tensors on ``mesh.device``, valid_n)."""
    padded, valid_n = pad_cloud(cloud, mesh.size)
    per = padded.n // mesh.size
    return _rows(padded, mesh.rank * per, (mesh.rank + 1) * per, mesh.device), valid_n

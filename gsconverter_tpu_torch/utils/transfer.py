"""Host <-> device residency of clouds and their leaves.

A cloud's leaves are host numpy arrays (the conversion pipeline's default:
readers hand back numpy, and codecs write from it) or torch tensors on one
device (``SplatCloud.device()``, a fit, the renderer).  Every stage computes
where the leaves it is given live; these helpers are the one place that
tells the two apart and brings device data to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def is_host(x) -> bool:
    """True when ``x`` is host-resident (numpy) data."""
    return isinstance(x, (np.ndarray, np.generic))


def cloud_is_host(cloud) -> bool:
    """True when the cloud's leaves live on the host (numpy pipeline)."""
    return is_host(cloud.pos)


def to_host(arr) -> np.ndarray:
    """numpy passes through; a tensor is copied to the host (one ``.cpu()``),
    a ``torch.uint32`` one by way of int64 (its words as numpy uint32)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach()
        if arr.dtype == torch.uint32:
            return arr.to(torch.int64).cpu().numpy().astype(np.uint32)
        return arr.cpu().numpy()
    return np.asarray(arr)


def tree_to_host(tree):
    """``to_host`` over nested dicts, lists and tuples (None leaves kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_host(v) for v in tree)
    return to_host(tree)

"""Host <-> device residency of clouds and their leaves.

A cloud's leaves are host numpy arrays (the conversion pipeline's default:
readers hand back numpy, and codecs write from it) or torch tensors on one
device (``SplatCloud.device()``, a fit, the renderer).  Every stage computes
where the leaves it is given live; these helpers are the one place that
tells the two apart and brings device data to the host.

They also count the host's blocking waits on a card: a copy to the host
(``to_host``), a copy from pageable host memory to the card (``upload``;
the copy waits for the card's stream) and a ``synchronize``.  While
tracing is on (``utils/log.py``) each wait is a ``wait`` span and adds
``host_waits`` and ``wait_bytes`` to the spans it lies in; while off it
costs the two flag checks of ``log.span`` and ``log.count``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import log


def _is_card(device) -> bool:
    """True when ``device`` (a ``torch.device`` or its name) is a card (a
    copy to or from it blocks)."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    return device.type == "cuda"


def is_host(x) -> bool:
    """True when ``x`` is host-resident (numpy) data."""
    return isinstance(x, (np.ndarray, np.generic))


def cloud_is_host(cloud) -> bool:
    """True when the cloud's leaves live on the host (numpy pipeline)."""
    return is_host(cloud.pos)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.to(torch.int64).cpu().numpy().astype(np.uint32)
    return t.cpu().numpy()


def to_host(arr) -> np.ndarray:
    """numpy passes through; a tensor is copied to the host (one ``.cpu()``),
    a ``torch.uint32`` one by way of int64 (its words as numpy uint32).
    The copy from a card is a counted wait."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach()
        if not _is_card(arr.device):
            return _numpy(arr)
        with log.span("wait"):
            log.count(host_waits=1, wait_bytes=arr.numel() * (
                8 if arr.dtype == torch.uint32 else arr.element_size()))
            return _numpy(arr)
    return np.asarray(arr)


def upload(arr, device) -> torch.Tensor:
    """``arr`` (numpy or a tensor) as a tensor on ``device`` by a blocking
    ``.to``.  A copy from the host (numpy, or a tensor off the cards) to a
    card is a counted wait, as is one from a card to the host."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    if _is_card(device) == (isinstance(arr, torch.Tensor) and _is_card(t.device)):
        return t.to(device)
    with log.span("wait"):
        log.count(host_waits=1, wait_bytes=t.numel() * t.element_size())
        return t.to(device)


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a card; nothing elsewhere):
    a counted wait."""
    if not _is_card(device):
        return
    with log.span("wait"):
        log.count(host_waits=1, wait_bytes=0)
        torch.cuda.synchronize(device)


def tree_to_host(tree):
    """``to_host`` over nested dicts, lists and tuples (None leaves kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_host(v) for v in tree)
    return to_host(tree)

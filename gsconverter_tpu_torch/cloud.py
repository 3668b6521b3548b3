"""SplatCloud — the canonical in-memory Gaussian-splat representation.

Structure-of-arrays over the splat axis N.  Leaves are host numpy arrays
(the conversion pipeline's default residency: the PLY reader hands back
zero-copy views over the mapped file) or torch tensors on one device; each
operation preserves the residency it is given.

Numerics contract (identical to the reference and to gsconverter_tpu):
  - ``pos``       [N,3] f32 world position (x, y, z)
  - ``normal``    [N,3] f32 (always 0 in practice; kept for PLY schema parity)
  - ``sh_dc``     [N,3] f32 SH DC; RGB = 0.5 + C0*dc, C0 = 0.28209479...
  - ``sh_rest``   [N,3,15] f32 SH AC at full degree-3 width, channel-major:
                  ``sh_rest[:, c, j]`` = channel c (RGB), coeff j — matching
                  the planar ``f_rest_{c*15+j}`` grouping (Inria order).
                  Lower active degrees are represented by zeroing the
                  per-channel tail.
  - ``opacity``   [N]   f32 logit: alpha = sigmoid(opacity)
  - ``log_scale`` [N,3] f32: linear scale = exp(log_scale)
  - ``quat``      [N,4] f32 quaternion in (w, x, y, z) order
  - ``rgb``       [N,3] u8 optional display RGB (sRGB-gamma'd)
  - ``extras``    dict[str -> [N,...]] pass-through non-standard PLY vertex
                  props

``active_sh_degree`` is metadata; ``extra_elements`` is a host-side sidecar
holding non-vertex PLY elements.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .config import resolve_device
from .ops.compaction import compact as _compact_on_device
from .utils.transfer import cloud_is_host, to_host

# Zeroth spherical-harmonic basis constant (reference data_processor.py:307).
SH_C0 = 0.28209479177387814

# Per-channel AC coefficient count by degree (reference spz.py:264-265).
DIM_FOR_DEGREE = {0: 0, 1: 3, 2: 8, 3: 15}
# Total AC coefficient count (3 channels) by degree.
COEFFS_FOR_DEGREE = {0: 0, 1: 9, 2: 24, 3: 45}
MAX_SH_DIM = 15  # degree 3 per-channel width

_LEAVES = ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat", "normal")


def covering_degree_for_dim(dim: int) -> int:
    """Smallest SH degree whose per-channel width COVERS ``dim`` coefficients.

    A non-standard f_rest count (e.g. 30 columns -> 10 per-channel coeffs,
    straddling bands 2/3) maps to a degree whose layout holds every
    populated coefficient; the content scan (ops/sh.detect_active_degree)
    later refines the degree down from this structural upper bound.
    """
    for deg in (0, 1, 2, 3):
        if DIM_FOR_DEGREE[deg] >= dim:
            return deg
    return 3


def _buffer_root(a: np.ndarray):
    """Walk the .base chain to the owning buffer object + its address."""
    b = a
    while isinstance(b, np.ndarray) and b.base is not None:
        b = b.base
    if isinstance(b, np.ndarray):
        addr = b.__array_interface__["data"][0]
    else:
        try:  # memoryview / mmap / bytes-like
            addr = np.frombuffer(b, np.uint8).__array_interface__["data"][0]
        except (TypeError, ValueError, BufferError):
            return None, 0
    return b, addr


def _shared_record_gather(named: dict, idx: np.ndarray) -> dict:
    """One-pass row gather for numpy view leaves sharing a record buffer.

    PLY reads hand the cloud zero-copy strided views over one mmap'd record
    array (formats/ply_gs.py); per-leaf ``np.take`` on such views re-reads
    the record cache lines once PER LEAF.  Gathering the shared records as
    raw [n, span] u8 rows instead costs one contiguous pass, and each leaf
    is peeled into its own contiguous output while the block is hot.

    Returns {name: gathered} for the leaves it handled; callers fall back
    to np.take for the rest.  Leaves qualify when they share a buffer root
    and a leading stride (the record size) and their row footprint fits in
    one record span.
    """
    groups: dict = {}
    for name, a in named.items():
        if not isinstance(a, np.ndarray) or a.ndim == 0 or a.base is None:
            continue
        if a.ndim == 1 or a.strides[0] <= 0:
            continue  # 1-D leaves are cheap to take; weird strides bail
        root, root_addr = _buffer_root(a)
        if root is None:
            continue
        rec = a.strides[0]
        off = a.__array_interface__["data"][0] - root_addr
        row_bytes = sum(
            (s - 1) * st for s, st in zip(a.shape[1:], a.strides[1:])
        ) + a.itemsize
        groups.setdefault((id(root), rec), []).append(
            (name, a, root, off, row_bytes)
        )

    out: dict = {}
    m = len(idx)
    chunk = 65536
    for (_, rec), members in groups.items():
        if len(members) < 2:
            continue  # no sharing to exploit
        n = members[0][1].shape[0]
        if any(a.shape[0] != n for _, a, _, _, _ in members):
            continue
        anchor = min(off for _, _, _, off, _ in members)
        span = max(off + rb for _, _, _, off, rb in members) - anchor
        if span > rec:
            continue
        root = members[0][2]
        try:
            rows = np.ndarray((n, span), np.uint8, buffer=root,
                              offset=anchor, strides=(rec, 1))
        except (TypeError, ValueError):
            continue
        dst = {
            name: np.empty((m,) + a.shape[1:], a.dtype)
            for name, a, _, _, _ in members
        }
        for s in range(0, m, chunk):
            sel = idx[s:s + chunk]
            g = rows[sel]  # contiguous [c, span] u8
            for name, a, _, off, _ in members:
                view = np.ndarray(
                    (len(sel),) + a.shape[1:], a.dtype, buffer=g,
                    offset=off - anchor, strides=(span,) + a.strides[1:],
                )
                dst[name][s:s + len(sel)] = view
        out.update(dst)
    return out


@dataclasses.dataclass
class SplatCloud:
    """Canonical SoA splat cloud: numpy or torch leaves, plus metadata."""

    pos: Any  # [N,3] f32
    sh_dc: Any  # [N,3] f32
    sh_rest: Any  # [N,3,15] f32
    opacity: Any  # [N] f32 logit
    log_scale: Any  # [N,3] f32
    quat: Any  # [N,4] f32 wxyz
    normal: Any  # [N,3] f32
    rgb: Any = None  # [N,3] u8
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
    active_sh_degree: int = 3
    extra_elements: tuple = ()

    # ---------------------------------------------------------------- basic
    def __len__(self) -> int:
        return int(self.pos.shape[0])

    @property
    def n(self) -> int:
        return int(self.pos.shape[0])

    @property
    def has_rgb(self) -> bool:
        return self.rgb is not None

    @property
    def is_host(self) -> bool:
        """True when leaves are host numpy (the IO pipeline's residency)."""
        return cloud_is_host(self)

    def replace(self, **kw: Any) -> "SplatCloud":
        return dataclasses.replace(self, **kw)

    def _named_leaves(self) -> dict:
        named = {name: getattr(self, name) for name in _LEAVES}
        if self.rgb is not None:
            named["rgb"] = self.rgb
        named.update({f"x:{k}": v for k, v in self.extras.items()})
        return named

    def _rebuild(self, named: dict) -> "SplatCloud":
        return self.replace(
            **{name: named[name] for name in _LEAVES},
            rgb=named.get("rgb"),
            extras={k: named[f"x:{k}"] for k in self.extras},
        )

    @staticmethod
    def sh_rest_from_flat(flat):
        """[N,K] channel-major flat coeffs (K in {0,9,24,45}) -> [N,3,15].

        Re-strides lower-degree planar layouts into the canonical degree-3
        width (the JAX package's divergence from the reference, whose PLY
        reader pads a 9/24-coeff file verbatim into 45 slots).
        """
        n, k = flat.shape
        dim = k // 3
        if isinstance(flat, np.ndarray):
            out = np.zeros((n, 3, MAX_SH_DIM), flat.dtype)
        else:
            out = torch.zeros((n, 3, MAX_SH_DIM), dtype=flat.dtype, device=flat.device)
        if k:
            out[:, :, :dim] = flat.reshape(n, 3, dim)
        return out

    # ------------------------------------------------------------ factories
    @classmethod
    def zeros(cls, n: int, active_sh_degree: int = 3, rgb: bool = False) -> "SplatCloud":
        """An n-splat host cloud of zeros with identity rotations."""
        f32 = np.float32
        quat = np.zeros((n, 4), f32)
        quat[:, 0] = 1.0
        return cls(
            pos=np.zeros((n, 3), f32),
            sh_dc=np.zeros((n, 3), f32),
            sh_rest=np.zeros((n, 3, MAX_SH_DIM), f32),
            opacity=np.zeros((n,), f32),
            log_scale=np.zeros((n, 3), f32),
            quat=quat,
            normal=np.zeros((n, 3), f32),
            rgb=np.zeros((n, 3), np.uint8) if rgb else None,
            active_sh_degree=active_sh_degree,
        )

    # --------------------------------------------------------- select/mask
    def select(self, idx) -> "SplatCloud":
        """Gather rows by index array (or boolean keep-mask).

        Residency-preserving: numpy-leaf clouds gather with numpy (one pass
        over shared PLY records), tensor clouds with ``index_select`` on
        their device.
        """
        named = self._named_leaves()
        if not self.is_host:
            idx = torch.as_tensor(idx, device=self.pos.device)
            if idx.dtype == torch.bool:
                return self.compact(idx)
            return self._rebuild(
                {name: a.index_select(0, idx) for name, a in named.items()})
        idx = np.asarray(idx)
        if idx.dtype == bool:
            # accept keep-masks too: np.take would silently read rows 0/1
            # and the record gather assumes integer indices
            idx = np.flatnonzero(idx)
        shared = _shared_record_gather(named, idx)

        def take(name, a):
            if name in shared:
                return shared[name]
            a = np.asarray(a)
            if a.ndim and a.strides[0] == 0 and a.shape[0]:
                # broadcast leaf (e.g. cap_degree's all-zero sh_rest): every
                # row is identical, so the gather is a broadcast
                return np.broadcast_to(a[0], (len(idx),) + a.shape[1:])
            return np.take(a, idx, axis=0)

        return self._rebuild({name: take(name, a) for name, a in named.items()})

    def compact(self, mask) -> "SplatCloud":
        """Boolean-mask compaction (changes N): a tensor cloud compacts on
        its device (``ops/compaction.py``), a host cloud in numpy."""
        if not self.is_host:
            return _compact_on_device(self, mask)
        return self.select(np.flatnonzero(to_host(mask)))

    # ------------------------------------------------------------- residency
    def to_numpy(self) -> "SplatCloud":
        """All leaves as host numpy arrays (host leaves pass through)."""
        return self._rebuild(
            {name: None if a is None else to_host(a)
             for name, a in self._named_leaves().items()})

    def device(self, device: str | torch.device | None = None) -> "SplatCloud":
        """All leaves as tensors on ``device``: the card unless the caller
        passes ``device="cpu"`` (``config.resolve_device``)."""
        return self.to_device(resolve_device(device))

    def block_until_ready(self) -> "SplatCloud":
        """Wait for the work queued on the cloud's device (host: no-op)."""
        if isinstance(self.pos, torch.Tensor) and self.pos.device.type == "cuda":
            torch.cuda.synchronize(self.pos.device)
        return self

    def to_device(self, device: str | torch.device) -> "SplatCloud":
        """All leaves as torch tensors on ``device``."""
        dev = torch.device(device)

        def conv(a):
            if a is None:
                return None
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return self._rebuild(
            {name: conv(a) for name, a in self._named_leaves().items()})

    @classmethod
    def from_numpy(cls, src: Any) -> "SplatCloud":
        """A host cloud from any object carrying the same leaves as numpy
        arrays — e.g. the JAX package's ``SplatCloud.to_numpy()`` — so both
        packages compute on the same data.  Leaves are copied."""

        def conv(a):
            return None if a is None else np.array(a)

        return cls(
            **{name: conv(getattr(src, name)) for name in _LEAVES},
            rgb=conv(getattr(src, "rgb", None)),
            extras={k: conv(v) for k, v in getattr(src, "extras", {}).items()},
            active_sh_degree=int(getattr(src, "active_sh_degree", 3)),
            extra_elements=tuple(getattr(src, "extra_elements", ())),
        )

"""Spherical-harmonics utilities: degree detection, capping, RGB synthesis.

Behavior contracts from the reference:
  - active-degree detection scans content backwards for the last non-zero
    AC coefficient (converter.py:119-146),
  - SH capping zeroes coefficients above the target degree and never
    upscales (data_processor.py:273-298, converter.py:165-188),
  - RGB synthesis: RGB = clip(0.5 + C0*dc, 0, 1)^(1/2.2) * 255 — note the
    deliberate sRGB gamma (data_processor.py:300-333).

Residency-generic: numpy leaves compute in numpy, tensor leaves in torch on
their own device.  ``eval_sh`` (the renderer's view-dependent color) takes
tensors only and is differentiable in ``sh_dc`` and ``sh_rest``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud import DIM_FOR_DEGREE, SH_C0, SplatCloud
from ..utils.transfer import is_host as _is_host, to_host

# Degree-aware real SH basis constants (standard 3DGS evaluation set).
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

# (degree, first coeff, end coeff) of each AC band, highest first
_BANDS = ((3, 8, 15), (2, 3, 8), (1, 0, 3))


def detect_active_degree(cloud: SplatCloud, max_degree: int | None = None) -> int:
    """Active SH degree from content (last non-zero AC coeff).

    ``max_degree``: structural upper bound from the source codec (its
    column count) — bands above it are zero by construction of the
    canonical [N,3,15] layout, so the scan skips them.  Only pass this for
    a cloud fresh from a reader; after processing, content is what counts.
    """
    rest = cloud.sh_rest
    top = 3 if max_degree is None else max(0, min(3, int(max_degree)))
    if isinstance(rest, np.ndarray):
        # Only the highest active band matters: scan band 3, then 2, then 1,
        # in row chunks with an early exit on the first nonzero.  A degree-3
        # source answers after one chunk instead of a full pass.
        n = rest.shape[0]
        chunk = 65536
        for degree, lo, hi in _BANDS:
            if degree > top:
                continue
            for i0 in range(0, n, chunk):
                if rest[i0:i0 + chunk, :, lo:hi].any():
                    return degree
        return 0
    # tensor leaves: one reduction on their device, 15 flags read back
    nonzero = to_host((rest != 0).any(dim=0).any(dim=0))
    active = np.nonzero(nonzero[:DIM_FOR_DEGREE[top]])[0]
    if active.size == 0:
        return 0
    last = int(active[-1])
    if last >= 8:
        return 3
    if last >= 3:
        return 2
    return 1


def effective_sh_degree(cloud: SplatCloud, kwargs: dict, cap: int) -> int:
    """Content SH degree for a codec write, capped at ``cap``.

    The converter already ran the content scan and passes the result as
    ``sh_content_degree`` in the write kwargs so codecs skip a second pass;
    direct handler users without the hint get the scan."""
    hint = kwargs.get("sh_content_degree")
    d = int(hint) if hint is not None else detect_active_degree(cloud)
    return min(d, cap)


def cap_degree(cloud: SplatCloud, degree: int | None) -> SplatCloud:
    """Zero AC coefficients above ``degree``
    (reference data_processor.py:273-298, indexes translated from flat
    f_rest_{i>=start} to per-channel coeff columns)."""
    if degree is None or degree >= 3:
        return cloud
    dim = DIM_FOR_DEGREE[degree]
    if isinstance(cloud.sh_rest, np.ndarray):
        if dim == 0:
            # all-zero result: a 0-stride broadcast view costs nothing;
            # downstream consumers only read it, and select rematerializes
            rest = np.broadcast_to(np.zeros((), np.float32), cloud.sh_rest.shape)
        else:
            # zero-fill + copy only the surviving columns
            rest = np.zeros_like(cloud.sh_rest)
            rest[:, :, :dim] = cloud.sh_rest[:, :, :dim]
    else:
        rest = torch.zeros_like(cloud.sh_rest)
        rest[:, :, :dim] = cloud.sh_rest[:, :, :dim]
    return cloud.replace(
        sh_rest=rest,
        active_sh_degree=min(cloud.active_sh_degree, degree),
    )


def rgb_linear_from_dc(sh_dc):
    """[N,3] linear RGB in [0,1] from SH DC."""
    if _is_host(sh_dc):
        return np.clip(0.5 + SH_C0 * sh_dc, 0.0, 1.0)
    return torch.clamp(0.5 + SH_C0 * sh_dc, 0.0, 1.0)


def rgb_u8_srgb_from_dc(sh_dc):
    """Display RGB with sRGB gamma (reference data_processor.py:321-333)."""
    lin = rgb_linear_from_dc(sh_dc)
    if _is_host(sh_dc):
        return (np.power(lin, 1.0 / 2.2) * 255.0).astype(np.uint8)
    return (torch.pow(lin, 1.0 / 2.2) * 255.0).to(torch.uint8)


def rgb_u8_linear_from_dc(sh_dc):
    """Linear-space u8 RGB used inside binary codecs (reference splat.py:135)."""
    if _is_host(sh_dc):
        return np.clip((0.5 + SH_C0 * sh_dc) * 255.0, 0.0, 255.0).astype(np.uint8)
    return torch.clamp((0.5 + SH_C0 * sh_dc) * 255.0, 0.0, 255.0).to(torch.uint8)


def dc_from_rgb_u8(rgb):
    """Inverse of the linear u8 mapping (reference splat.py:75-77)."""
    if _is_host(rgb):
        return (rgb.astype(np.float32) / 255.0 - 0.5) / SH_C0
    return (rgb.to(torch.float32) / 255.0 - 0.5) / SH_C0


def add_rgb(cloud: SplatCloud) -> SplatCloud:
    """Attach display RGB synthesized from DC if missing
    (reference data_processor.py:233-271).  Residency-preserving."""
    if cloud.rgb is not None:
        return cloud
    return cloud.replace(rgb=rgb_u8_srgb_from_dc(cloud.sh_dc))


def _band(rest: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """sum_j rest[n, c, j] * basis[n, j] -> [N, 3]."""
    return (rest * basis[:, None, :]).sum(-1)


def eval_sh(cloud: SplatCloud, dirs: torch.Tensor, degree: int | None = None) -> torch.Tensor:
    """Evaluate view-dependent color for unit view dirs [N,3] -> linear RGB [N,3].

    Used by the differentiable rasterizer; degree defaults to the cloud's
    active degree. Standard real-SH basis (same convention as Inria 3DGS).
    ``cloud``'s ``sh_dc`` / ``sh_rest`` are tensors on ``dirs``' device.
    """
    deg = cloud.active_sh_degree if degree is None else degree
    c = 0.5 + SH_C0 * cloud.sh_dc  # [N,3]
    if deg == 0:
        return c
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    rest = cloud.sh_rest  # [N,3,15] channel-major
    b1 = torch.cat([-y, z, -x], dim=1) * SH_C1  # coeffs 0..2
    c = c + _band(rest[:, :, 0:3], b1)
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        b2 = torch.cat([
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ], dim=1)
        c = c + _band(rest[:, :, 3:8], b2)
    if deg >= 3:
        xx, yy, zz = x * x, y * y, z * z
        xy = x * y
        b3 = torch.cat([
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ], dim=1)
        c = c + _band(rest[:, :, 8:15], b3)
    return c

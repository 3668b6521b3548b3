"""Spherical-harmonics utilities: degree detection, capping, RGB synthesis.

Behavior contracts from the reference:
  - active-degree detection scans content backwards for the last non-zero
    AC coefficient (converter.py:119-146),
  - SH capping zeroes coefficients above the target degree and never
    upscales (data_processor.py:273-298, converter.py:165-188),
  - RGB synthesis: RGB = clip(0.5 + C0*dc, 0, 1)^(1/2.2) * 255 — note the
    deliberate sRGB gamma (data_processor.py:300-333).

Residency-generic: numpy leaves compute in numpy, tensor leaves in torch on
their own device.  ``eval_sh`` waits for the renderer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud import DIM_FOR_DEGREE, SH_C0, SplatCloud

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
    nonzero = (rest != 0).any(dim=0).any(dim=0).cpu().numpy()
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


def _is_host(a) -> bool:
    return isinstance(a, (np.ndarray, np.generic))


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

"""Quantize / dequantize ops used by the .splat and SOG codecs and SOR.

Residency-generic like the JAX package's ``ops/quant.py``: each function
computes with numpy when handed host numpy arrays and with torch when
handed tensors (on any device).  Only the schemes this package's codecs
use are here; the rest of the JAX module waits for the codecs that use it.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SQRT2 = 1.4142135623730951


def _is_host(a) -> bool:
    return isinstance(a, (np.ndarray, np.generic))


# ------------------------------------------------------------------ opacity


def sigmoid(x):
    if _is_host(x):
        with np.errstate(over="ignore"):
            return 1.0 / (1.0 + np.exp(-x))
    return torch.sigmoid(x)


def u8_to_logit_splat(u8):
    """.splat flavor: clip to [1/255, 0.9999] (reference splat.py:67-69)."""
    if _is_host(u8):
        v = np.clip(u8.astype(np.float32) / 255.0, 1.0 / 255.0, 0.9999)
        return -np.log(1.0 / v - 1.0)
    v = torch.clamp(u8.to(torch.float32) / 255.0, 1.0 / 255.0, 0.9999)
    return -torch.log(1.0 / v - 1.0)


# --------------------------------------------------------------- quaternion


def normalize_quat(q, eps: float = 1e-12):
    if _is_host(q):
        return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), eps)
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def quat_to_u8(q):
    """u8 = clip(val*128+128) per component (reference splat.py:124-129)."""
    if _is_host(q):
        return np.clip(q * 128.0 + 128.0, 0, 255).astype(np.uint8)
    return torch.clamp(q * 128.0 + 128.0, 0, 255).to(torch.uint8)


def u8_to_quat(u8):
    """Inverse with renormalization (reference splat.py:52-63)."""
    if _is_host(u8):
        q = (u8.astype(np.float32) - 128.0) / 128.0
    else:
        q = (u8.to(torch.float32) - 128.0) / 128.0
    return normalize_quat(q, eps=1e-6)


# ------------------------------- smallest-three rotation, SOG flavor (u8x3)
# Layout (reference sog.py:315-388): normalize, flip so the largest (by |.|,
# WXYZ order) is positive, multiply by sqrt(2), store the three non-largest
# components as u8 = (v*0.5+0.5)*255, alpha channel = 252 + largest_idx.


def pack_rot_sog(quat_wxyz):
    """[N,4] wxyz quaternions -> (u8 [N,3], alpha u8 [N])."""
    q = quat_wxyz
    if _is_host(q):
        # argmax on the raw quat: normalization is a positive per-row
        # scale, so the component order is unchanged; flip, normalize and
        # sqrt(2) fuse into one [N,1] scale
        max_idx = np.argmax(np.abs(q), axis=1)
        max_val = np.take_along_axis(q, max_idx[:, None], axis=1)
        nrm = np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
        q = q * (np.where(max_val >= 0, SQRT2, -SQRT2) / nrm)
        # the 3 non-max components in ascending index order
        slots = np.arange(3)[None, :]
        comp = slots + (slots >= max_idx[:, None])
        rest = np.take_along_axis(q, comp, axis=1)
        u8 = np.clip((rest * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
        return u8, (252 + max_idx).astype(np.uint8)
    max_idx = torch.argmax(q.abs(), dim=1)
    max_val = torch.gather(q, 1, max_idx[:, None])
    nrm = torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    q = q * (torch.where(max_val >= 0, SQRT2, -SQRT2) / nrm)
    slots = torch.arange(3, device=q.device)[None, :]
    comp = slots + (slots >= max_idx[:, None]).to(slots.dtype)
    rest = torch.gather(q, 1, comp)
    u8 = torch.clamp((rest * 0.5 + 0.5) * 255.0, 0, 255).to(torch.uint8)
    return u8, (252 + max_idx).to(torch.uint8)


def unpack_rot_sog(u8, alpha):
    """Inverse of ``pack_rot_sog``: (u8 [N,3], alpha [N]) -> [N,4] wxyz."""
    if _is_host(u8):
        max_idx = np.clip(alpha.astype(np.int32) - 252, 0, 3)
        rest = (u8.astype(np.float32) / 255.0 - 0.5) * 2.0
        missing = np.sqrt(np.maximum(1.0 - np.sum(rest * rest, axis=1), 0.0))
        is_max = np.arange(4)[None, :] == max_idx[:, None]
        slot = np.cumsum(np.where(is_max, 0, 1), axis=1) - np.where(is_max, 0, 1)
        gathered = np.take_along_axis(rest, np.clip(slot, 0, 2), axis=1)
        return np.where(is_max, missing[:, None], gathered)
    max_idx = torch.clamp(alpha.to(torch.int64) - 252, 0, 3)
    rest = (u8.to(torch.float32) / 255.0 - 0.5) * 2.0
    missing = torch.sqrt(torch.clamp(1.0 - (rest * rest).sum(1), min=0.0))
    is_max = torch.arange(4, device=u8.device)[None, :] == max_idx[:, None]
    step = (~is_max).to(torch.int64)
    slot = torch.cumsum(step, dim=1) - step
    gathered = torch.gather(rest, 1, torch.clamp(slot, 0, 2))
    return torch.where(is_max, missing[:, None], gathered)


# ------------------------------------------------------------ codebook ops


def nearest_codebook_index(vals, codebook):
    """Nearest entry in a SORTED 1-D codebook (reference sog.py:408-419).

    One searchsorted against the cell midpoints: val maps to entry i iff
    mid[i-1] <= val < mid[i].  A value exactly on a midpoint snaps to the
    right entry.  Returns int32 indices.
    """
    mid = (codebook[1:] + codebook[:-1]) * 0.5
    if not _is_host(vals):
        return torch.searchsorted(mid, vals.contiguous(), right=True).to(torch.int32)
    if vals.size > 2_000_000:
        # np.searchsorted releases the GIL: split a large lookup across
        # threads (the same per-element op, so bit-identical to one call)
        flat = vals.reshape(-1)
        out = np.empty(flat.shape[0], np.int32)
        nw = min(4, os.cpu_count() or 1)
        step = -(-flat.shape[0] // nw)

        def work(s):
            e = min(s + step, flat.shape[0])
            out[s:e] = np.searchsorted(mid, flat[s:e], side="right")

        with ThreadPoolExecutor(nw) as ex:
            list(ex.map(work, range(0, flat.shape[0], step)))
        return out.reshape(vals.shape)
    return np.searchsorted(mid, vals, side="right").astype(np.int32)


# ------------------------------------------------------------- morton code


def morton3_u32(ix, iy, iz):
    """Interleave 10-bit coords into a 30-bit Morton code.

    numpy inputs give uint32 codes.  Tensors give int64 codes: torch has no
    ``<<`` on uint32 on the CPU, and 30 bits fit an int64 exactly.
    """
    if _is_host(ix):
        u = np.uint32

        def part(n):
            n = n.astype(u) & u(0x000003FF)
            n = (n ^ (n << 16)) & u(0xFF0000FF)
            n = (n ^ (n << 8)) & u(0x0300F00F)
            n = (n ^ (n << 4)) & u(0x030C30C3)
            n = (n ^ (n << 2)) & u(0x09249249)
            return n

        return ((part(iz) << 2) | (part(iy) << 1) | part(ix)).astype(u)

    def tpart(n):
        n = n.to(torch.int64) & 0x000003FF
        n = (n ^ (n << 16)) & 0xFF0000FF
        n = (n ^ (n << 8)) & 0x0300F00F
        n = (n ^ (n << 4)) & 0x030C30C3
        n = (n ^ (n << 2)) & 0x09249249
        return n

    return (tpart(iz) << 2) | (tpart(iy) << 1) | tpart(ix)

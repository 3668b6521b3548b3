"""Quantize / dequantize ops used by the .splat codec and SOR.

Residency-generic like the JAX package's ``ops/quant.py``: each function
computes with numpy when handed host numpy arrays and with torch when
handed tensors (on any device).  Only the schemes this package's codecs
use are here; the rest of the JAX module waits for the codecs that use it.
"""

from __future__ import annotations

import numpy as np
import torch


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

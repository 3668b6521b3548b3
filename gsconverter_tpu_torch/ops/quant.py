"""Quantize / dequantize bit-ops shared by the format codecs and SOR.

  - logit <-> linear-u8 opacity            (reference spz.py:122, ksplat.py:24-27)
  - quaternion u8 (val*128+128)            (splat.py:52-63, 124-129)
  - 24-bit fixed-point positions           (spz.py:112-117, 190-197)
  - smallest-three u32 rotation, SPZ flavor (spz.py:267-343)
  - smallest-three u32 rotation, compressed-PLY flavor (compressed_ply.py:321-378)
  - smallest-three u8x3+idx, SOG flavor    (sog.py:315-388)
  - 11-10-11 and 8-8-8-8 packed u32        (compressed_ply.py:299-319, 342-358)
  - SPZ bit-snapped SH u8                  (spz.py:162-170)
  - codebook nearest lookup                (sog.py:408-419)

Residency-generic like the JAX package's ``ops/quant.py``: each function
computes with numpy when handed host numpy arrays and with torch when
handed tensors (on any device).  Packed u32 words are built in int64 on
the torch side (torch has no ``<<`` on uint32 on the CPU) and cast to
``torch.uint32`` at the end.  The codecs encode on the host in numpy; the
torch branches give the same bits wherever the math is IEEE arithmetic,
while ``exp``/``log`` may differ by an ulp between numpy and torch.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils.transfer import is_host as _is_host

SQRT1_2 = 0.7071067811865476
SQRT2 = 1.4142135623730951


# ------------------------------------------------------------------ opacity


def sigmoid(x):
    """1/(1+exp(-x)), the same formula on both residencies."""
    if _is_host(x):
        with np.errstate(over="ignore"):
            return 1.0 / (1.0 + np.exp(-x))
    return 1.0 / (1.0 + torch.exp(-x))


def logit_to_u8(opacity_logit, clip: float = 20.0):
    """alpha_u8 = sigmoid(logit)*255 (reference spz.py:122)."""
    if _is_host(opacity_logit):
        a = sigmoid(np.clip(opacity_logit, -clip, clip))
        return np.clip(a * 255.0, 0, 255).astype(np.uint8)
    # 1/(1+exp(-x)), the host formula, rather than torch.sigmoid
    a = 1.0 / (1.0 + torch.exp(-torch.clamp(opacity_logit, -clip, clip)))
    return torch.clamp(a * 255.0, 0, 255).to(torch.uint8)


def u8_to_logit(u8, eps: float = 1e-7):
    """Inverse sigmoid of u8/255 (reference spz.py:345-348, ksplat.py:24-27)."""
    if _is_host(u8):
        v = np.clip(u8.astype(np.float32) / 255.0, eps, 1.0 - eps)
        return np.log(v / (1.0 - v))
    v = torch.clamp(u8.to(torch.float32) / 255.0, eps, 1.0 - eps)
    return torch.log(v / (1.0 - v))


def u8_to_logit_splat(u8):
    """.splat flavor: clip to [1/255, 0.9999] (reference splat.py:67-69)."""
    if _is_host(u8):
        v = np.clip(u8.astype(np.float32) / 255.0, 1.0 / 255.0, 0.9999)
        return -np.log(1.0 / v - 1.0)
    v = torch.clamp(u8.to(torch.float32) / 255.0, 1.0 / 255.0, 0.9999)
    return -torch.log(1.0 / v - 1.0)


# --------------------------------------------------------------- quaternion


def _t_norm(q):
    """||q|| over the last axis, keepdim: the squares added in index order
    and a correctly rounded root, as ``np.linalg.norm`` forms it."""
    s = q * q
    acc = s[..., 0]
    for i in range(1, q.shape[-1]):
        acc = acc + s[..., i]
    return _t_sqrt(acc)[..., None]


def normalize_quat(q, eps: float = 1e-12):
    if _is_host(q):
        return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), eps)
    return q / torch.clamp(_t_norm(q), min=eps)


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


def _t_sum_sq3(v):
    """sum(v * v, axis=1) of an [N,3] tensor, added in numpy's order."""
    return (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]


def _t_sqrt(x):
    """Correctly rounded f32 square root: the f64 root rounded once."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _t_slots(is_max):
    """Slot of each component among the three non-max ones, in index
    order (the max's own entry is meaningless and clamped)."""
    step = (~is_max).to(torch.int64)
    return torch.clamp(torch.cumsum(step, dim=1) - step, 0, 2)


# ------------------------------------------------- 24-bit fixed point (SPZ)


def pos_to_fixed24(pos, frac_bits: int):
    """[N,3] f32 -> [N,3,3] u8 little-endian 24-bit signed fixed point
    (reference spz.py:112-116)."""
    scale = float(1 << frac_bits)
    if _is_host(pos):
        q = np.round(pos * scale).astype(np.int32)
        return np.stack([(q & 0xFF).astype(np.uint8),
                         ((q >> 8) & 0xFF).astype(np.uint8),
                         ((q >> 16) & 0xFF).astype(np.uint8)], axis=-1)
    q = torch.round(pos * scale).to(torch.int32)
    return torch.stack([(q & 0xFF).to(torch.uint8),
                        ((q >> 8) & 0xFF).to(torch.uint8),
                        ((q >> 16) & 0xFF).to(torch.uint8)], dim=-1)


def fixed24_to_pos(b, frac_bits: int):
    """[N,3,3] u8 -> [N,3] f32 with sign extension (reference spz.py:190-197)."""
    if _is_host(b):
        b0, b1, b2 = (b[..., i].astype(np.int32) for i in range(3))
        i32 = b0 | (b1 << 8) | (b2 << 16)
        i32 = np.where((i32 & 0x800000) != 0, i32 | (~0xFFFFFF), i32)
        return i32.astype(np.float32) / float(1 << frac_bits)
    b0, b1, b2 = (b[..., i].to(torch.int32) for i in range(3))
    i32 = b0 | (b1 << 8) | (b2 << 16)
    i32 = torch.where((i32 & 0x800000) != 0, i32 | (~0xFFFFFF), i32)
    return i32.to(torch.float32) / float(1 << frac_bits)


# -------------------------------------- smallest-three rotation, SPZ flavor
# Layout (reference spz.py:268-272): bits 30-31 = index of the largest
# |component| in XYZW order; bits 20-29 / 10-19 / 0-9 = the other three in
# ascending index order, each a sign bit (bit 9) and a 9-bit magnitude
# scaled by 511/sqrt(1/2); components are negated when the largest is
# negative.


def pack_rot_spz(quat_wxyz):
    """[N,4] wxyz quaternions -> [N] u32."""
    q = normalize_quat(quat_wxyz + 0.0)
    scale = 511.0 / SQRT1_2
    if _is_host(q):
        R = np.stack([q[:, 1], q[:, 2], q[:, 3], q[:, 0]], axis=1)
        max_idx = np.argmax(np.abs(R), axis=1)
        max_val = np.take_along_axis(R, max_idx[:, None], axis=1)[:, 0]
        should_neg = max_val < 0
        packed = max_idx.astype(np.uint32) << 30
        is_max = np.arange(4)[None, :] == max_idx[:, None]
        slot = np.cumsum(np.where(is_max, 0, 1), axis=1) - np.where(is_max, 0, 1)
        negbit = ((R < 0) != should_neg[:, None]).astype(np.uint32)
        mag = np.clip(np.abs(R) * scale + 0.5, 0, 511).astype(np.uint32)
        component = (negbit << 9) | mag
        shift = ((2 - slot) * 10).astype(np.uint32)
        contrib = np.where(is_max, 0, component << shift).astype(np.uint32)
        return (packed | contrib[:, 0] | contrib[:, 1] | contrib[:, 2]
                | contrib[:, 3]).astype(np.uint32)
    R = torch.stack([q[:, 1], q[:, 2], q[:, 3], q[:, 0]], dim=1)
    max_idx = torch.argmax(R.abs(), dim=1)
    should_neg = torch.gather(R, 1, max_idx[:, None])[:, 0] < 0
    is_max = torch.arange(4, device=q.device)[None, :] == max_idx[:, None]
    negbit = ((R < 0) != should_neg[:, None]).to(torch.int64)
    mag = torch.clamp(R.abs() * scale + 0.5, 0, 511).to(torch.int64)
    contrib = ((negbit << 9) | mag) << ((2 - _t_slots(is_max)) * 10)
    contrib = torch.where(is_max, 0, contrib)
    packed = (max_idx << 30) | contrib[:, 0] | contrib[:, 1] | contrib[:, 2] | contrib[:, 3]
    return packed.to(torch.uint32)


def unpack_rot_spz(packed):
    """[N] u32 -> quat wxyz [N,4] (reference spz.py:267-296)."""
    if _is_host(packed):
        packed = packed.astype(np.uint32)
        idx = (packed >> 30) & 0x3
        raw = np.stack([(packed >> 20) & 0x3FF, (packed >> 10) & 0x3FF,
                        packed & 0x3FF], axis=1)
        mag = (raw & 0x1FF).astype(np.float32) / 511.0 * SQRT1_2
        neg = ((raw >> 9) & 0x1).astype(np.float32)
        v = mag * (1.0 - 2.0 * neg)
        missing = np.sqrt(np.maximum(0.0, 1.0 - np.sum(v * v, axis=1)))
        is_max = np.arange(4)[None, :] == idx[:, None].astype(np.int32)
        slot = np.cumsum(np.where(is_max, 0, 1), axis=1) - np.where(is_max, 0, 1)
        gathered = np.take_along_axis(v, np.clip(slot, 0, 2), axis=1)
        xyzw = np.where(is_max, missing[:, None], gathered)
        return np.stack([xyzw[:, 3], xyzw[:, 0], xyzw[:, 1], xyzw[:, 2]], axis=1)
    packed = packed.to(torch.int64)
    idx = (packed >> 30) & 0x3
    raw = torch.stack([(packed >> 20) & 0x3FF, (packed >> 10) & 0x3FF,
                       packed & 0x3FF], dim=1)
    mag = (raw & 0x1FF).to(torch.float32) / 511.0 * SQRT1_2
    neg = ((raw >> 9) & 0x1).to(torch.float32)
    v = mag * (1.0 - 2.0 * neg)
    missing = _t_sqrt(torch.clamp(1.0 - _t_sum_sq3(v), min=0.0))
    is_max = torch.arange(4, device=v.device)[None, :] == idx[:, None]
    xyzw = torch.where(is_max, missing[:, None], torch.gather(v, 1, _t_slots(is_max)))
    return torch.stack([xyzw[:, 3], xyzw[:, 0], xyzw[:, 1], xyzw[:, 2]], dim=1)


# ---------------------- smallest-three rotation, compressed-PLY flavor
# Layout (reference compressed_ply.py:321-340): bits 30-31 = index of the
# largest in WXYZ order; the other components in ascending order as 10-bit
# unorm of (v*sqrt(1/2)+0.5); all components sign-flipped so the largest
# is positive.


def pack_rot_cply(quat_wxyz):
    """[N,4] wxyz quaternions -> [N] u32."""
    q = normalize_quat(quat_wxyz + 0.0)
    t = 1023.0
    if _is_host(q):
        largest = np.argmax(np.abs(q), axis=1)
        q = q * np.sign(np.take_along_axis(q, largest[:, None], axis=1))
        res = largest.astype(np.uint32)
        # the reference folds the components in index order:
        # res = (res << 10) | comp for each non-largest i in 0..3
        for i in range(4):
            comp = np.clip(np.floor((q[:, i] * SQRT1_2 + 0.5) * t + 0.5),
                           0, t).astype(np.uint32)
            res = np.where(largest != i, (res << 10) | comp, res).astype(np.uint32)
        return res
    largest = torch.argmax(q.abs(), dim=1)
    q = q * torch.sign(torch.gather(q, 1, largest[:, None]))
    res = largest
    for i in range(4):
        comp = torch.clamp(torch.floor((q[:, i] * SQRT1_2 + 0.5) * t + 0.5),
                           0, t).to(torch.int64)
        res = torch.where(largest != i, (res << 10) | comp, res)
    return res.to(torch.uint32)


def unpack_rot_cply(packed):
    """[N] u32 -> quat wxyz [N,4]."""
    if _is_host(packed):
        packed = packed.astype(np.uint32)
        largest = packed >> 30
        v = np.stack([(packed >> 20) & 0x3FF, (packed >> 10) & 0x3FF,
                      packed & 0x3FF], axis=1)
        dv = (v.astype(np.float32) / 1023.0 - 0.5) / SQRT1_2
        missing = np.sqrt(np.clip(1.0 - np.sum(dv * dv, axis=1), 0.0, 1.0))
        is_max = np.arange(4)[None, :] == largest[:, None].astype(np.int32)
        slot = np.cumsum(np.where(is_max, 0, 1), axis=1) - np.where(is_max, 0, 1)
        gathered = np.take_along_axis(dv, np.clip(slot, 0, 2), axis=1)
        return np.where(is_max, missing[:, None], gathered)
    packed = packed.to(torch.int64)
    largest = packed >> 30
    v = torch.stack([(packed >> 20) & 0x3FF, (packed >> 10) & 0x3FF,
                     packed & 0x3FF], dim=1)
    dv = (v.to(torch.float32) / 1023.0 - 0.5) / SQRT1_2
    missing = _t_sqrt(torch.clamp(1.0 - _t_sum_sq3(dv), 0.0, 1.0))
    is_max = torch.arange(4, device=dv.device)[None, :] == largest[:, None]
    return torch.where(is_max, missing[:, None], torch.gather(dv, 1, _t_slots(is_max)))


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
    nrm = torch.clamp(_t_norm(q), min=1e-12)
    # numpy forms the [N,1] scale from Python floats, so in f64, and the
    # rest of the encode with it
    f64 = torch.float64
    sgn = torch.where(max_val >= 0, torch.tensor(SQRT2, dtype=f64, device=q.device),
                      torch.tensor(-SQRT2, dtype=f64, device=q.device))
    q = q.to(f64) * (sgn / nrm.to(f64))
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
    return torch.where(is_max, missing[:, None], torch.gather(rest, 1, _t_slots(is_max)))


# --------------------------------------------------- 11-10-11 / 8888 packing


def _unit(v, mins, maxs):
    """v normalized to [mins, maxs] per column; degenerate ranges (< 1e-5)
    give 0, as the reference packs them."""
    rng = maxs - mins
    if _is_host(v):
        return np.where(rng[None, :] < 1e-5, 0.0,
                        (v - mins[None, :]) / np.where(rng == 0, 1.0, rng)[None, :])
    return torch.where(rng[None, :] < 1e-5, 0.0,
                       (v - mins[None, :]) / torch.where(rng == 0, 1.0, rng)[None, :])


def pack_11_10_11(xyz, mins, maxs):
    """[N,3] f32 + [3] bounds -> [N] u32 (reference compressed_ply.py:299-308)."""
    norm = _unit(xyz, mins, maxs)
    if _is_host(xyz):
        t = ((1 << np.asarray([11, 10, 11])) - 1).astype(np.float32)
        q = np.clip(np.floor(norm * t[None, :] + 0.5), 0, t[None, :]).astype(np.uint32)
        return (q[:, 0] << 21) | (q[:, 1] << 11) | q[:, 2]
    t = torch.tensor([2047.0, 1023.0, 2047.0], device=xyz.device)
    q = torch.minimum(torch.clamp(torch.floor(norm * t[None, :] + 0.5), min=0),
                      t[None, :]).to(torch.int64)
    return ((q[:, 0] << 21) | (q[:, 1] << 11) | q[:, 2]).to(torch.uint32)


def unpack_11_10_11(packed, mins, maxs):
    """[N] u32 + [3] bounds -> [N,3] f32."""
    if _is_host(packed):
        packed = packed.astype(np.uint32)
        q = np.stack([(packed >> 21) & 0x7FF, (packed >> 11) & 0x3FF,
                      packed & 0x7FF], axis=1).astype(np.float32)
        t = np.asarray([2047.0, 1023.0, 2047.0], dtype=np.float32)
    else:
        packed = packed.to(torch.int64)
        q = torch.stack([(packed >> 21) & 0x7FF, (packed >> 11) & 0x3FF,
                         packed & 0x7FF], dim=1).to(torch.float32)
        t = torch.tensor([2047.0, 1023.0, 2047.0], device=q.device)
    return q / t[None, :] * (maxs - mins)[None, :] + mins[None, :]


def pack_8888(rgb, alpha, mins, maxs):
    """rgb [N,3] normalized to the bounds, alpha [N] absolute -> [N] u32
    (reference compressed_ply.py:310-319)."""
    norm = _unit(rgb, mins, maxs)
    if _is_host(rgb):
        q = np.clip(np.floor(norm * 255.0 + 0.5), 0, 255).astype(np.uint32)
        qa = np.clip(np.floor(alpha * 255.0 + 0.5), 0, 255).astype(np.uint32)
        return (q[:, 0] << 24) | (q[:, 1] << 16) | (q[:, 2] << 8) | qa
    q = torch.clamp(torch.floor(norm * 255.0 + 0.5), 0, 255).to(torch.int64)
    qa = torch.clamp(torch.floor(alpha * 255.0 + 0.5), 0, 255).to(torch.int64)
    return ((q[:, 0] << 24) | (q[:, 1] << 16) | (q[:, 2] << 8) | qa).to(torch.uint32)


def unpack_8888(packed, mins, maxs):
    """[N] u32 -> (rgb [N,3] within the bounds, alpha [N] in [0, 1])."""
    if _is_host(packed):
        packed = packed.astype(np.uint32)
        q = np.stack([(packed >> 24) & 0xFF, (packed >> 16) & 0xFF,
                      (packed >> 8) & 0xFF], axis=1).astype(np.float32)
        alpha = (packed & 0xFF).astype(np.float32) / 255.0
    else:
        packed = packed.to(torch.int64)
        q = torch.stack([(packed >> 24) & 0xFF, (packed >> 16) & 0xFF,
                         (packed >> 8) & 0xFF], dim=1).to(torch.float32)
        alpha = (packed & 0xFF).to(torch.float32) / 255.0
    return q / 255.0 * (maxs - mins)[None, :] + mins[None, :], alpha


# -------------------------------------------------------- SPZ SH bit-snap


def quant_sh_spz(vals, bits: int):
    """u8 with (8-bits)-step snapping (reference spz.py:162-165)."""
    bs = 1 << (8 - bits)
    if _is_host(vals):
        q = np.round(vals * 128.0 + 128.0).astype(np.int32)
        return np.clip((q + bs // 2) // bs * bs, 0, 255).astype(np.uint8)
    q = torch.round(vals * 128.0 + 128.0).to(torch.int32)
    return torch.clamp(torch.div(q + bs // 2, bs, rounding_mode="floor") * bs,
                       0, 255).to(torch.uint8)


def dequant_sh_spz(u8):
    if _is_host(u8):
        return (u8.astype(np.float32) - 128.0) / 128.0
    return (u8.to(torch.float32) - 128.0) / 128.0


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

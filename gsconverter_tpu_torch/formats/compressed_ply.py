"""PlayCanvas / splat-transform "compressed PLY" codec.

Container (reference formats/compressed_ply.py): PLY with three elements —
``chunk`` (per-256-splat min/max bounds, 18 f32), ``vertex`` (4 packed u32
per splat: position 11-10-11, rotation 2+10-10-10 smallest-three, scale
11-10-11, color 8888) and optional ``sh`` (u8 per AC coeff in [-4,4]).

As in the JAX package, the rows are ordered by one two-level Morton key
(10 + 10 bits an axis) instead of the reference's recursive Morton sort:
the same spatial-locality contract without data-dependent recursion.  A
host cloud encodes in numpy.  A tensor cloud encodes where its tensors live
(the Morton order a stable sort of the 60-bit key ``key_hi << 30 | key_lo``,
``np.lexsort``'s order), and only the packed words and chunk bounds come to
the host; ``sigmoid`` may differ from numpy's by an ulp, moving an alpha
byte by one step.  An empty cloud raises ``ValueError``: the format's
chunk bounds need at least one splat.  A write is two spans
(``utils/log.py``): ``encode`` (the packing and its readbacks) and ``file``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud import COEFFS_FOR_DEGREE, SH_C0, SplatCloud, covering_degree_for_dim
from ..ops import quant
from ..ops.sh import effective_sh_degree
from ..utils import ply
from ..utils.log import debug_print, span, status_print
from ..utils.transfer import to_host
from .base import BaseFormat, register
from .ply_gs import Ply3DGSFormat

CHUNK = 256

_CHUNK_FIELDS = [
    "min_x", "min_y", "min_z", "max_x", "max_y", "max_z",
    "min_scale_x", "min_scale_y", "min_scale_z",
    "max_scale_x", "max_scale_y", "max_scale_z",
    "min_r", "min_g", "min_b", "max_r", "max_g", "max_b",
]


def morton_order(pos):
    """Two-level Morton sort of [N,3] positions: a 10-bit key of the
    position normalized to its bounds (a zero extent takes a range of 1),
    then a 10-bit key of the remainder within its cell; ``lexsort`` takes
    the coarse key as the primary one.  numpy in, numpy out; a tensor in,
    an int64 order on its device out."""
    if pos.shape[0] == 0:
        raise ValueError("morton_order: no positions to order (empty cloud)")
    if isinstance(pos, torch.Tensor):
        return _morton_order_torch(pos)
    mins = np.min(pos, axis=0)
    maxs = np.max(pos, axis=0)
    rng = np.where(maxs - mins > 0, maxs - mins, 1.0)
    t = (pos - mins) / rng
    hi = np.clip(t * 1024.0, 0, 1023).astype(np.uint32)
    lo = np.clip((t * 1024.0 - hi) * 1024.0, 0, 1023).astype(np.uint32)
    key_hi = quant.morton3_u32(hi[:, 0], hi[:, 1], hi[:, 2])
    key_lo = quant.morton3_u32(lo[:, 0], lo[:, 1], lo[:, 2])
    return np.lexsort((key_lo, key_hi))


def _morton_order_torch(pos: torch.Tensor) -> torch.Tensor:
    mins = pos.amin(dim=0)
    maxs = pos.amax(dim=0)
    rng = torch.where(maxs - mins > 0, maxs - mins, 1.0)
    t = (pos - mins) / rng
    t1024 = t * 1024.0
    hi = torch.clamp(t1024, 0, 1023).to(torch.int64)
    # numpy forms ``t * 1024.0 - hi`` (f32 minus uint32) in f64
    lo = torch.clamp((t1024.to(torch.float64) - hi) * 1024.0, 0, 1023).to(torch.int64)
    key_hi = quant.morton3_u32(hi[:, 0], hi[:, 1], hi[:, 2])
    key_lo = quant.morton3_u32(lo[:, 0], lo[:, 1], lo[:, 2])
    return torch.sort((key_hi << 30) | key_lo, stable=True).indices


def _pad_to_chunks(a):
    """Pad axis 0 to a multiple of CHUNK by edge replication (keeps min/max)."""
    pad = (-a.shape[0]) % CHUNK
    if pad:
        if isinstance(a, torch.Tensor):
            a = torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))], dim=0)
        else:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)], axis=0)
    return a.reshape((-1, CHUNK) + tuple(a.shape[1:]))


def _chunk_unit(cv, mins, maxs):
    """[C, CHUNK, 3] values normalized to their chunk's [C, 3] bounds."""
    rng = maxs - mins
    if isinstance(cv, torch.Tensor):
        return torch.where(
            rng[:, None, :] < 1e-5, 0.0,
            (cv - mins[:, None, :]) / torch.where(rng == 0, 1.0, rng)[:, None, :])
    return np.where(
        rng[:, None, :] < 1e-5, 0.0,
        (cv - mins[:, None, :]) / np.where(rng == 0, 1.0, rng)[:, None, :],
    )


def _unit_bounds(like):
    if isinstance(like, torch.Tensor):
        return (torch.zeros(3, device=like.device), torch.ones(3, device=like.device))
    return np.zeros(3, np.float32), np.ones(3, np.float32)


def _pack_chunked(cv, mins, maxs):
    """Per-chunk-normalized 11-10-11 pack over [C, CHUNK, 3] values; packing
    the normalized values against unit bounds is bit-identical to packing
    against the chunk bounds (the pack's own normalization divides by 1)."""
    return quant.pack_11_10_11(_chunk_unit(cv, mins, maxs).reshape(-1, 3),
                               *_unit_bounds(cv))


def _encode(pos, log_scale, quat, opacity, sh_dc):
    """(order, chunk bounds [C,18], the four packed u32 words): numpy on a
    host cloud's leaves, torch on a tensor cloud's device."""
    tensor = isinstance(pos, torch.Tensor)
    order = morton_order(pos)
    pos = pos[order]
    scl = (torch.clamp if tensor else np.clip)(log_scale[order], -20, 20)
    rgb = sh_dc[order] * SH_C0 + 0.5
    alpha = quant.sigmoid(opacity[order])

    cpos, cscl, crgb = _pad_to_chunks(pos), _pad_to_chunks(scl), _pad_to_chunks(rgb)
    if tensor:
        (mins_p, maxs_p), (mins_s, maxs_s), (mins_c, maxs_c) = (
            torch.aminmax(a, dim=1) for a in (cpos, cscl, crgb))
    else:
        mins_p, maxs_p = np.min(cpos, axis=1), np.max(cpos, axis=1)
        mins_s, maxs_s = np.min(cscl, axis=1), np.max(cscl, axis=1)
        mins_c, maxs_c = np.min(crgb, axis=1), np.max(crgb, axis=1)

    p_pos = _pack_chunked(cpos, mins_p, maxs_p)
    p_scl = _pack_chunked(cscl, mins_s, maxs_s)
    p_col = quant.pack_8888(
        _chunk_unit(crgb, mins_c, maxs_c).reshape(-1, 3),
        _pad_to_chunks(alpha).reshape(-1), *_unit_bounds(crgb),
    )
    p_rot = quant.pack_rot_cply(quat[order])
    n = pos.shape[0]
    bounds = [mins_p, maxs_p, mins_s, maxs_s, mins_c, maxs_c]
    chunk_bounds = (torch.cat(bounds, dim=1) if tensor
                    else np.concatenate(bounds, axis=1))
    return order, chunk_bounds, p_pos[:n], p_rot, p_scl[:n], p_col[:n]


def _decode(p_pos, p_rot, p_scl, p_col, chunk_bounds):
    """Host decode: (pos, log_scale, quat, sh_dc, opacity)."""
    mins_p, maxs_p = chunk_bounds[:, 0:3], chunk_bounds[:, 3:6]
    mins_s, maxs_s = chunk_bounds[:, 6:9], chunk_bounds[:, 9:12]
    mins_c, maxs_c = chunk_bounds[:, 12:15], chunk_bounds[:, 15:18]
    cidx = np.arange(p_pos.shape[0]) // CHUNK
    zero3, one3 = np.zeros(3, np.float32), np.ones(3, np.float32)
    # unpack against unit bounds, then rescale each row to its chunk's
    pos = quant.unpack_11_10_11(p_pos, zero3, one3)
    pos = pos * (maxs_p - mins_p)[cidx] + mins_p[cidx]
    scl = quant.unpack_11_10_11(p_scl, zero3, one3)
    scl = scl * (maxs_s - mins_s)[cidx] + mins_s[cidx]
    rgb01, alpha = quant.unpack_8888(p_col, zero3, one3)
    rgb01 = rgb01 * (maxs_c - mins_c)[cidx] + mins_c[cidx]
    quat = quant.unpack_rot_cply(p_rot)
    sh_dc = (rgb01 - 0.5) / SH_C0
    a = np.clip(alpha, 1e-6, 1.0 - 1e-6)
    opacity = np.log(a / (1.0 - a))
    return pos, scl, quat, sh_dc, opacity


@register
class CompressedPlyFormat(BaseFormat):
    name = "compressed_ply"
    extension = ".ply"
    max_sh_degree = 3

    def read(self, path: str, **kwargs) -> SplatCloud:
        plyf = ply.read(path)
        if "chunk" not in plyf:
            debug_print("[WARNING] No 'chunk' element; falling back to standard PLY read.")
            return Ply3DGSFormat().read(path, **kwargs)
        chunks = plyf["chunk"].data
        verts = plyf["vertex"].data
        n = len(verts)
        chunk_bounds = np.stack([chunks[f] for f in _CHUNK_FIELDS], axis=1).astype(np.float32)
        pos, scl, quat, sh_dc, opacity = _decode(
            np.ascontiguousarray(verts["packed_position"]),
            np.ascontiguousarray(verts["packed_rotation"]),
            np.ascontiguousarray(verts["packed_scale"]),
            np.ascontiguousarray(verts["packed_color"]),
            chunk_bounds,
        )

        sh_rest = np.zeros((n, 3, 15), np.float32)
        sh_deg = 0
        if "sh" in plyf:
            sh_el = plyf["sh"].data
            names = list(sh_el.dtype.names)
            flat = np.stack([sh_el[f] for f in names], axis=1).astype(np.float32)
            sh_rest = SplatCloud.sh_rest_from_flat((flat / 256.0 - 0.5) * 8.0)
            # covering degree (rounds up), so no populated band is dropped
            sh_deg = covering_degree_for_dim(len(names) // 3)
        self.metadata = dict(count=n, sh_degree=sh_deg, chunks=len(chunks))
        return SplatCloud(
            pos=pos, sh_dc=sh_dc, sh_rest=sh_rest, opacity=opacity,
            log_scale=scl, quat=quat,
            normal=np.zeros((n, 3), np.float32),
            active_sh_degree=sh_deg,
        )

    def write(self, cloud: SplatCloud, path: str, **kwargs) -> None:
        c = cloud
        n = c.n
        if n == 0:
            raise ValueError("compressed PLY: cannot write an empty cloud "
                             "(its chunk bounds need at least one splat)")
        with span("encode"):
            order, *packed = _encode(c.pos, c.log_scale, c.quat, c.opacity, c.sh_dc)
            chunk_bounds, p_pos, p_rot, p_scl, p_col = map(to_host, packed)
            nc = len(chunk_bounds)
            chunk_arr = np.zeros(nc, dtype=[(f, "<f4") for f in _CHUNK_FIELDS])
            for i, f in enumerate(_CHUNK_FIELDS):
                chunk_arr[f] = chunk_bounds[:, i]
            vert_arr = np.zeros(
                n,
                dtype=[("packed_position", "<u4"), ("packed_rotation", "<u4"),
                       ("packed_scale", "<u4"), ("packed_color", "<u4")],
            )
            vert_arr["packed_position"] = p_pos
            vert_arr["packed_rotation"] = p_rot
            vert_arr["packed_scale"] = p_scl
            vert_arr["packed_color"] = p_col
            elements = [ply.PlyElement("chunk", chunk_arr), ply.PlyElement("vertex", vert_arr)]

            n_coeffs = COEFFS_FOR_DEGREE[effective_sh_degree(c, kwargs, 3)]
            if n_coeffs > 0:
                # degree-packed channel-major (stride = per-channel dim), the
                # splat-transform convention
                flat = c.sh_rest[:, :, :n_coeffs // 3].reshape(n, n_coeffs)[order]
                if c.is_host:
                    q = np.clip((flat / 8.0 + 0.5) * 256.0, 0, 255).astype(np.uint8)
                else:
                    # x / 8 and x * 0.125 are the same f32 (a power of two)
                    q = to_host(torch.clamp((flat * 0.125 + 0.5) * 256.0, 0, 255)
                                .to(torch.uint8))
                sh_arr = np.zeros(n, dtype=[(f"f_rest_{i}", "u1") for i in range(n_coeffs)])
                for i in range(n_coeffs):
                    sh_arr[f"f_rest_{i}"] = q[:, i]
                elements.append(ply.PlyElement("sh", sh_arr))

        with span("file"):
            ply.write(path, elements)
        status_print(f"Compressed PLY write completed. {n} points in {nc} chunks.")

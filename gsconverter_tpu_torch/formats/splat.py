"""antimatter15 .splat codec.

32-byte records: pos f32x3, linear scale f32x3, RGBA u8x4, quat u8x4 packed
as val*128+128 (reference formats/splat.py).  Writer sorts splats descending
by exp(sum(log_scale)) * sigmoid(opacity) (reference splat.py:92-98).

A host cloud encodes in numpy.  A tensor cloud encodes where its tensors
live, with a stable sort of the metric; only the packed fields (32 bytes a
splat) come to the host.  The host's ``np.argsort`` is not stable, so rows
with tied metrics may take another order there; ``exp`` and ``sigmoid`` may
differ from numpy's by an ulp, moving a scale by an ulp and an alpha byte
by one step.  A write is two spans (``utils/log.py``): ``encode`` (the
records and their readbacks) and ``file``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..cloud import SplatCloud
from ..ops import quant, sh
from ..utils.log import debug_print, span
from ..utils.transfer import to_host
from .base import BaseFormat, register

_RECORD = np.dtype(
    [("pos", "<f4", (3,)), ("scale", "<f4", (3,)), ("color", "u1", (4,)), ("rot", "u1", (4,))]
)


def _encode(c: SplatCloud) -> dict:
    """The record's fields: numpy arithmetic on a host cloud, torch on a
    tensor cloud's device (the same formulas).  The one difference is the
    order of tied metrics: numpy's ``argsort`` is not stable, torch's sort
    is asked to be."""
    host = c.is_host
    xp_exp = np.exp if host else torch.exp
    alpha_lin = quant.sigmoid(c.opacity)
    metric = xp_exp(c.log_scale.sum(1)) * alpha_lin
    order = np.argsort(-metric) if host else torch.sort(-metric, stable=True).indices
    alpha = (np.clip(alpha_lin[order] * 255.0, 0, 255).astype(np.uint8) if host
             else torch.clamp(alpha_lin[order] * 255.0, 0, 255).to(torch.uint8))
    rgb = sh.rgb_u8_linear_from_dc(c.sh_dc[order])
    color = (np.concatenate([rgb, alpha[:, None]], axis=1) if host
             else torch.cat([rgb, alpha[:, None]], dim=1))
    return dict(pos=c.pos[order], scale=xp_exp(c.log_scale[order]), color=color,
                rot=quant.quat_to_u8(quant.normalize_quat(c.quat[order])))


@register
class SplatFormat(BaseFormat):
    name = "splat"
    extension = ".splat"
    max_sh_degree = 0
    needs_rgb = True

    def read(self, path: str, **kwargs) -> SplatCloud:
        size = os.path.getsize(path)
        if size % _RECORD.itemsize != 0:
            debug_print(f"[WARNING] {size} not a multiple of 32; truncating.")
        raw = np.fromfile(path, dtype=_RECORD)
        n = len(raw)
        scales = np.ascontiguousarray(raw["scale"])
        log_scale = np.log(np.maximum(scales, 1e-6))
        quat = quant.u8_to_quat(np.ascontiguousarray(raw["rot"]))
        color = np.ascontiguousarray(raw["color"])
        sh_dc = sh.dc_from_rgb_u8(color[:, :3])
        opacity = quant.u8_to_logit_splat(color[:, 3])
        return SplatCloud(
            pos=np.ascontiguousarray(raw["pos"]),
            sh_dc=sh_dc,
            sh_rest=np.zeros((n, 3, 15), np.float32),
            opacity=opacity,
            log_scale=log_scale,
            quat=quat,
            normal=np.zeros((n, 3), np.float32),
            rgb=np.ascontiguousarray(color[:, :3]),
            active_sh_degree=0,
        )

    def write(self, cloud: SplatCloud, path: str, **kwargs) -> None:
        n = cloud.n
        with span("encode"):
            out = np.zeros(n, dtype=_RECORD)
            for name, field in _encode(cloud).items():
                out[name] = to_host(field)
        with span("file"), open(path, "wb") as f:
            f.write(memoryview(out))  # zero-copy buffer write
        debug_print(f".splat write completed. {n} splats sorted and packed.")

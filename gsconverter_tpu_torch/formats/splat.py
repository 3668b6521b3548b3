"""antimatter15 .splat codec.

32-byte records: pos f32x3, linear scale f32x3, RGBA u8x4, quat u8x4 packed
as val*128+128 (reference formats/splat.py).  Writer sorts splats descending
by exp(sum(log_scale)) * sigmoid(opacity) (reference splat.py:92-98).

The packed record is the file, so encode and decode run on the host in
numpy; a cloud with tensor leaves is brought to the host first.
"""

from __future__ import annotations

import os

import numpy as np

from ..cloud import SplatCloud
from ..ops import quant, sh
from ..utils.log import debug_print
from .base import BaseFormat, register

_RECORD = np.dtype(
    [("pos", "<f4", (3,)), ("scale", "<f4", (3,)), ("color", "u1", (4,)), ("rot", "u1", (4,))]
)


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
        c = cloud if cloud.is_host else cloud.to_numpy()
        n = c.n
        out = np.zeros(n, dtype=_RECORD)
        alpha_lin = quant.sigmoid(c.opacity)
        metric = np.exp(np.sum(c.log_scale, axis=1)) * alpha_lin
        order = np.argsort(-metric)
        out["pos"] = c.pos[order]
        out["scale"] = np.exp(c.log_scale[order])
        a = np.clip(alpha_lin[order] * 255.0, 0, 255)
        out["color"][:, :3] = sh.rgb_u8_linear_from_dc(c.sh_dc[order])
        out["color"][:, 3] = a.astype(np.uint8)
        out["rot"] = quant.quat_to_u8(quant.normalize_quat(c.quat[order]))
        with open(path, "wb") as f:
            f.write(memoryview(out))  # zero-copy buffer write
        debug_print(f".splat write completed. {n} splats sorted and packed.")

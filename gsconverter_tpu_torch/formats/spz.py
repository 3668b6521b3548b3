"""Niantic .spz codec (versions 1-3).

Container layout (reference formats/spz.py): gzip around a 16-byte header
(magic 0x5053474e, '<IIIBBBB': magic, version, num_points, sh_degree,
fractional_bits, flags, reserved) followed by planar sections:
positions | alpha | colors | scales | rotations | SH.

Quantization contract (``ops.quant`` and here):
  - positions: v1 f16, v2+ 24-bit fixed point (frac_bits, default 12)
  - alpha u8 = sigmoid(logit)*255
  - colors u8 = (dc*0.15 + 0.5)*255
  - scales u8 = (log_scale+10)*16
  - rotation: v3 smallest-three u32, legacy first-three u8x3
  - SH u8 around 128 with 5-bit (degree-1 block) / 4-bit (higher) snapping.

The writer emits version 3 with flags=1 (FlagAntialiased), as the reference
does, and gzips with ``mtime=0`` so a rerun writes the same bytes.  Encode
and decode of a host cloud run in numpy.  A tensor cloud is quantized where
its tensors live (``ops.quant``'s torch branches, the same arithmetic), and
only the quantized sections come to the host for the gzip; ``sigmoid`` may
differ from numpy's by an ulp, moving an alpha byte by one step.  A write
is three spans (``utils/log.py``): ``encode`` (quantization and the
readbacks), ``compress`` (the gzip) and ``file``.
"""

from __future__ import annotations

import gzip
import struct

import numpy as np
import torch

from ..cloud import DIM_FOR_DEGREE, SplatCloud
from ..ops import quant, sh
from ..ops.sh import effective_sh_degree
from ..utils.log import debug_print, span, status_print
from ..utils.transfer import to_host
from .base import BaseFormat, register

MAGIC = 0x5053474E
COLOR_SCALE = 0.15


def _encode_core(pos, opacity, sh_dc, log_scale, quat):
    """(pos 24-bit [N,3,3], alpha, color [N,3], scales [N,3], rotation u32),
    numpy in, numpy out; tensors in, tensors on their device out."""
    pos_b = quant.pos_to_fixed24(pos, 12)
    alpha = quant.logit_to_u8(opacity)
    if isinstance(pos, torch.Tensor):
        col = torch.clamp((sh_dc * COLOR_SCALE + 0.5) * 255.0, 0, 255).to(torch.uint8)
        scales = torch.clamp((log_scale + 10.0) * 16.0, 0, 255).to(torch.uint8)
    else:
        col = np.clip((sh_dc * COLOR_SCALE + 0.5) * 255.0, 0, 255).astype(np.uint8)
        scales = np.clip((log_scale + 10.0) * 16.0, 0, 255).astype(np.uint8)
    rot = quant.pack_rot_spz(quat)
    return pos_b, alpha, col, scales, rot


def _encode_sh(sh_rest_flat_interleaved, sh_dim: int):
    """[N, sh_dim*3] coeff-major interleaved (R0,G0,B0,R1,...) -> snapped u8."""
    q5 = quant.quant_sh_spz(sh_rest_flat_interleaved[:, :9], 5)
    if sh_dim > 3:
        q4 = quant.quant_sh_spz(sh_rest_flat_interleaved[:, 9:], 4)
        if isinstance(q5, torch.Tensor):
            return torch.cat([q5, q4], dim=1)
        return np.concatenate([q5, q4], axis=1)
    return q5


@register
class SpzFormat(BaseFormat):
    name = "spz"
    extension = ".spz"
    max_sh_degree = 3

    def read(self, path: str, **kwargs) -> SplatCloud:
        with open(path, "rb") as f:
            file_data = f.read()
        if len(file_data) > 2 and file_data[0] == 0x1F and file_data[1] == 0x8B:
            file_data = gzip.decompress(file_data)
        if len(file_data) < 16:
            raise ValueError("Decompressed SPZ data too short for header")
        magic, version, n, sh_deg, frac_bits, flags, _ = struct.unpack(
            "<IIIBBBB", file_data[:16])
        if magic != MAGIC:
            raise ValueError(f"Invalid SPZ magic number: {hex(magic)}")
        if version < 1 or version > 3:
            raise ValueError(f"Unsupported SPZ version: {version}")
        debug_print(f"[DEBUG] SPZ Header: Ver={version}, N={n}, SH={sh_deg}")
        self.metadata = dict(version=version, sh_degree=sh_deg, frac_bits=frac_bits,
                             flags=flags)
        body = file_data[16:]
        ptr = 0

        if version == 1:
            pos = np.frombuffer(body, np.float16, n * 3, ptr).reshape(n, 3).astype(np.float32)
            ptr += n * 6
        else:
            raw = np.frombuffer(body, np.uint8, n * 9, ptr).reshape(n, 3, 3)
            pos = quant.fixed24_to_pos(raw, frac_bits)
            ptr += n * 9
        alpha_u8 = np.frombuffer(body, np.uint8, n, ptr)
        ptr += n
        col_u8 = np.frombuffer(body, np.uint8, n * 3, ptr).reshape(n, 3)
        ptr += n * 3
        scale_u8 = np.frombuffer(body, np.uint8, n * 3, ptr).reshape(n, 3)
        ptr += n * 3
        if version >= 3:
            rot_raw = np.frombuffer(body, np.uint32, n, ptr)
            ptr += n * 4
            quat = quant.unpack_rot_spz(rot_raw)
        else:
            rot_raw = np.frombuffer(body, np.uint8, n * 3, ptr).reshape(n, 3)
            ptr += n * 3
            xyz = rot_raw.astype(np.float32) / 127.5 - 1.0
            w = np.sqrt(np.maximum(0.0, 1.0 - np.sum(xyz * xyz, axis=1)))
            quat = np.concatenate([w[:, None], xyz], axis=1)

        opacity = quant.u8_to_logit(alpha_u8)
        sh_dc = (col_u8.astype(np.float32) / 255.0 - 0.5) / COLOR_SCALE
        log_scale = scale_u8.astype(np.float32) / 16.0 - 10.0

        sh_dim = DIM_FOR_DEGREE.get(sh_deg, 0)
        sh_rest = np.zeros((n, 3, 15), np.float32)
        if sh_dim > 0:
            raw = np.frombuffer(body, np.uint8, n * sh_dim * 3, ptr).reshape(n, sh_dim, 3)
            # [N, dim, 3] coeff-major -> channel-major
            sh_rest[:, :, :sh_dim] = np.transpose(quant.dequant_sh_spz(raw), (0, 2, 1))

        return SplatCloud(
            pos=pos, sh_dc=sh_dc, sh_rest=sh_rest, opacity=opacity,
            log_scale=log_scale, quat=quat,
            normal=np.zeros((n, 3), np.float32), rgb=sh.rgb_u8_linear_from_dc(sh_dc),
            active_sh_degree=sh_deg,
        )

    def write(self, cloud: SplatCloud, path: str, **kwargs) -> None:
        c = cloud
        n = c.n
        with span("encode"):
            sh_deg = effective_sh_degree(c, kwargs, self.max_sh_degree)
            debug_print(f"[DEBUG] SPZ Write: effective SH degree {sh_deg} (from content).")

            # host: numpy; tensors: quantized on their device, then pulled
            pos_b, alpha, col, scales, rot = _encode_core(
                c.pos, c.opacity, c.sh_dc, c.log_scale, c.quat)
            parts = [to_host(pos_b).reshape(n, 9).tobytes(), to_host(alpha).tobytes(),
                     to_host(col).tobytes(), to_host(scales).tobytes(),
                     to_host(rot).astype("<u4").tobytes()]
            sh_dim = DIM_FOR_DEGREE[sh_deg]
            if sh_dim > 0:
                # canonical [N,3,15] channel-major -> coeff-major R0,G0,B0,...
                if c.is_host:
                    inter = np.transpose(c.sh_rest[:, :, :sh_dim], (0, 2, 1))
                else:
                    inter = c.sh_rest[:, :, :sh_dim].transpose(1, 2)
                inter = inter.reshape(n, sh_dim * 3)
                parts.append(np.ascontiguousarray(to_host(_encode_sh(inter, sh_dim))).tobytes())

        comp_level = int(kwargs.get("compression_level", 0) or 0)
        with span("compress"):
            header = struct.pack("<IIIBBBB", MAGIC, 3, n, sh_deg, 12, 1, 0)
            # mtime=0: the current time would land in the gzip header
            payload = gzip.compress(header + b"".join(parts), compresslevel=comp_level,
                                    mtime=0)
        with span("file"), open(path, "wb") as f:
            f.write(payload)
        status_print(f"Native SPZ (v3, lvl={comp_level}) export completed. {n} points.")

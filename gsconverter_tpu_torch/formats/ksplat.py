"""mkkellogg .ksplat codec.

Container (reference formats/ksplat.py): 4096-byte file header + 1024-byte
per-section headers + payload of [partial-bucket lengths u32] [bucket center
f32x3] [interleaved splat records].  Compression levels: 0 = f32 everywhere;
1 = u16 bucket-relative positions, f16 scale/rot/SH; 2 = same but u8 SH in
the header's [min_sh, max_sh] range (the writer writes [-2, 2], reference
ksplat.py:379).  SH degree capped at 2.

At level >= 1 the writer orders the rows by the compressed-PLY Morton key so
that buckets are spatially tight, and sizes the block so no bucket-relative
offset saturates (both as the JAX package does).  The record is streamed
to the file in chunks.  A host cloud encodes in numpy; a tensor cloud
computes the Morton order, bucket centres, block size, quantized positions,
colours and the rest of each chunk's record where its tensors live, and
only the record's fields come to the host.  ``exp`` and ``sigmoid`` may
differ from numpy's by an ulp: a level-0 scale by an ulp, an alpha byte or
an f16 scale by one step.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..cloud import SH_C0, SplatCloud
from ..ops import quant
from ..ops.sh import effective_sh_degree
from ..utils.log import debug_print, status_print
from ..utils.transfer import to_host
from .base import BaseFormat, register
from .compressed_ply import morton_order

HEADER_SIZE = 4096
SECTION_HEADER_SIZE = 1024
MAGIC_MAJOR, MAGIC_MINOR = 0, 1
SCALE_RANGE = 32767
#: rows a streamed write encodes at a time (a multiple of every bucket size
#: that divides it; buckets are indexed by absolute row)
STREAM_ROWS = 262144

_SH_COUNT = {0: 0, 1: 9, 2: 24}


def _record_dtype(comp: int, sh_count: int) -> np.dtype:
    if comp == 0:
        rec = [("pos", "<3f4"), ("scale", "<3f4"), ("rot", "<4f4"), ("color", "4u1")]
        sh = "<f4"
    else:
        rec = [("pos", "<3u2"), ("scale", "<3u2"), ("rot", "<4u2"), ("color", "4u1")]
        sh = "<f2" if comp == 1 else "u1"
    if sh_count:
        rec.append(("sh", sh, (sh_count,)))
    return np.dtype(rec)


def _bucket_centers(pos, bucket_size: int):
    """AABB centers of consecutive buckets, the last padded by its last row
    (reference ksplat.py:426-444).  numpy or a tensor, as ``pos``."""
    pad = (-pos.shape[0]) % bucket_size
    if isinstance(pos, torch.Tensor):
        p = torch.cat([pos, pos[-1:].expand(pad, 3)]) if pad else pos
        lo, hi = torch.aminmax(p.reshape(-1, bucket_size, 3), dim=1)
        return (lo + hi) / 2.0
    p = np.concatenate([pos, np.repeat(pos[-1:], pad, axis=0)]) if pad else pos
    b = p.reshape(-1, bucket_size, 3)
    return (b.min(axis=1) + b.max(axis=1)) / 2.0


def _encode_rows(c: SplatCloud, s: int, e: int, comp: int, centers, bucket_size: int,
                 sf_inv: float, sh_dim: int, min_sh: float, max_sh: float) -> dict:
    """Rows s:e of the record as numpy fields: numpy arithmetic on a host
    cloud, torch on a tensor cloud's device (the same formulas)."""
    host = c.is_host
    xp_clip = np.clip if host else torch.clamp
    xp_exp = np.exp if host else torch.exp
    xp_round = np.round if host else torch.round

    def as_u(a, np_dt, t_dt):
        return a.astype(np_dt) if host else a.to(t_dt)

    f = {}
    rgb = as_u(xp_clip((0.5 + SH_C0 * c.sh_dc[s:e]) * 255.0, 0, 255), np.uint8, torch.uint8)
    alpha = as_u(xp_clip(quant.sigmoid(c.opacity[s:e]) * 255.0, 0, 255),
                 np.uint8, torch.uint8)
    f["color"] = (np.concatenate([rgb, alpha[:, None]], axis=1) if host
                  else torch.cat([rgb, alpha[:, None]], dim=1))
    if comp == 0:
        f["pos"] = c.pos[s:e]
        f["scale"] = xp_exp(c.log_scale[s:e])
        f["rot"] = c.quat[s:e]
    else:
        if host:
            cidx = np.arange(s, e) // bucket_size
            sqrt2 = quant.SQRT2
        else:
            cidx = torch.arange(s, e, device=c.pos.device) // bucket_size
            # a CUDA divide by a Python scalar multiplies by its f32
            # reciprocal: divide by a device tensor, as numpy divides
            sqrt2 = torch.tensor(quant.SQRT2, dtype=torch.float32, device=c.pos.device)
        qp = xp_round((c.pos[s:e] - centers[cidx]) * sf_inv) + SCALE_RANGE
        f["pos"] = as_u(xp_clip(qp, 0, 65535), np.uint16, torch.int32)
        f["scale"] = as_u(xp_exp(c.log_scale[s:e]), np.float16, torch.float16)
        # the reader's integer convention, (u-32767.5)/32767.5*sqrt2
        # (reference ksplat.py:225-226), not the reference writer's f16
        # bits, so encode -> decode round-trips
        f["rot"] = as_u(xp_clip(xp_round(c.quat[s:e] / sqrt2 * 32767.5 + 32767.5),
                                0, 65535), np.uint16, torch.int32)
    if sh_dim:
        # degree-packed channel-major: R0..Rd, G0..Gd, B0..Bd
        shc = c.sh_rest[s:e, :, :sh_dim].reshape(e - s, 3 * sh_dim)
        if comp == 2:
            # / 4.0 (max_sh - min_sh) is exact as a reciprocal multiply
            f["sh"] = as_u(xp_clip((shc - min_sh) / (max_sh - min_sh) * 255.0, 0, 255),
                           np.uint8, torch.uint8)
        elif comp == 1:
            f["sh"] = as_u(shc, np.float16, torch.float16)
        else:
            f["sh"] = shc
    if host:
        return f
    out = {k: v.cpu().numpy() for k, v in f.items()}
    if comp:
        out["pos"] = out["pos"].astype(np.uint16)
        out["rot"] = out["rot"].astype(np.uint16)
    return out


@register
class KSplatFormat(BaseFormat):
    name = "ksplat"
    extension = ".ksplat"
    max_sh_degree = 2
    needs_rgb = True

    # ------------------------------------------------------------------ read
    def read(self, path: str, **kwargs) -> SplatCloud:
        with open(path, "rb") as f:
            header = f.read(HEADER_SIZE)
            v_major, v_minor = header[0], header[1]
            if (v_major, v_minor) != (MAGIC_MAJOR, MAGIC_MINOR):
                debug_print(f"[DEBUG] KSplat version mismatch: {v_major}.{v_minor}")
            max_sections = struct.unpack_from("<I", header, 4)[0]
            splat_count = struct.unpack_from("<I", header, 16)[0]
            comp = struct.unpack_from("<H", header, 20)[0]
            min_sh = struct.unpack_from("<f", header, 36)[0]
            max_sh = struct.unpack_from("<f", header, 40)[0]
            self.metadata = dict(
                v_major=v_major, v_minor=v_minor, splat_count=splat_count,
                compression_level=comp, min_sh=min_sh, max_sh=max_sh, sections=[],
            )
            sections = []
            for _ in range(max_sections):
                sdata = f.read(SECTION_HEADER_SIZE)
                if len(sdata) < SECTION_HEADER_SIZE:
                    break
                s = dict(
                    splatCount=struct.unpack_from("<I", sdata, 0)[0],
                    maxSplatCount=struct.unpack_from("<I", sdata, 4)[0],
                    bucketSize=struct.unpack_from("<I", sdata, 8)[0],
                    bucketCount=struct.unpack_from("<I", sdata, 12)[0],
                    bucketBlockSize=struct.unpack_from("<f", sdata, 16)[0],
                    bucketStorageSizeBytes=struct.unpack_from("<H", sdata, 20)[0],
                    compressionScaleRange=struct.unpack_from("<I", sdata, 24)[0],
                    storageSizeBytes=struct.unpack_from("<I", sdata, 28)[0],
                    fullBucketCount=struct.unpack_from("<I", sdata, 32)[0],
                    partiallyFilledBucketCount=struct.unpack_from("<I", sdata, 36)[0],
                    shDegree=struct.unpack_from("<H", sdata, 40)[0],
                )
                if s["compressionScaleRange"] == 0 and comp >= 1:
                    s["compressionScaleRange"] = SCALE_RANGE
                sections.append(s)
                self.metadata["sections"].append(s)
            payload = f.read()

        parts = []
        offset = 0
        global_deg = max((s["shDegree"] for s in sections), default=0)
        for s in sections:
            part, offset = self._read_section(payload, offset, s, comp)
            parts.append(part)
        if not parts:
            return SplatCloud.zeros(0, active_sh_degree=global_deg)
        merged = {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
        n = merged["pos"].shape[0]
        return SplatCloud(
            pos=merged["pos"], sh_dc=merged["sh_dc"], sh_rest=merged["sh_rest"],
            opacity=merged["opacity"], log_scale=merged["log_scale"],
            quat=merged["quat"], normal=np.zeros((n, 3), np.float32),
            active_sh_degree=global_deg,
        )

    def _read_section(self, payload: bytes, offset: int, s: dict, comp: int):
        pfb = s["partiallyFilledBucketCount"]
        pfb_lengths = np.frombuffer(payload, np.uint32, pfb, offset)
        offset += pfb * 4
        bcount = s["bucketCount"]
        centers = np.frombuffer(payload, np.float32, bcount * 3, offset).reshape(-1, 3)
        offset += bcount * 12

        n = s["splatCount"]
        sh_count = _SH_COUNT.get(s["shDegree"], 0)
        dt = _record_dtype(comp, sh_count)
        raw = np.frombuffer(payload, dt, n, offset)
        offset += s["maxSplatCount"] * dt.itemsize

        if comp == 0:
            pos = np.ascontiguousarray(raw["pos"])
            log_scale = np.log(np.maximum(np.ascontiguousarray(raw["scale"]), 1e-9))
            quat = np.ascontiguousarray(raw["rot"])
        else:
            # bucket of each row: the full buckets, then the partial ones
            # (reference ksplat.py:148-156)
            fb, bsz = s["fullBucketCount"], s["bucketSize"]
            assign = np.concatenate(
                [np.repeat(np.arange(fb), bsz)]
                + [np.full(int(ln), fb + i) for i, ln in enumerate(pfb_lengths)])
            assign = assign[:n].astype(np.int64)
            sf = (s["bucketBlockSize"] / 2.0) / s["compressionScaleRange"]
            pos_u = raw["pos"].astype(np.float32)
            pos = (pos_u - s["compressionScaleRange"]) * sf + centers[assign]
            scales = np.ascontiguousarray(raw["scale"]).view(np.float16).astype(np.float32)
            log_scale = np.log(np.maximum(scales, 1e-9))
            r_u = raw["rot"].astype(np.float32)
            quat = (r_u - 32767.5) / 32767.5 * quant.SQRT2

        color = np.ascontiguousarray(raw["color"])
        sh_dc = (color[:, :3].astype(np.float32) / 255.0 - 0.5) / SH_C0
        opacity = quant.u8_to_logit(color[:, 3])

        sh_rest = np.zeros((n, 3, 15), np.float32)
        if sh_count:
            vals = raw["sh"].astype(np.float32)
            if comp == 2:
                # the header's range (the reference decodes (u8-128)/128,
                # which is its written range [-2, 2] up to scale)
                min_sh = self.metadata["min_sh"]
                max_sh = self.metadata["max_sh"]
                vals = vals / 255.0 * (max_sh - min_sh) + min_sh
            sh_rest = SplatCloud.sh_rest_from_flat(vals)
        return (
            dict(pos=pos, sh_dc=sh_dc, sh_rest=sh_rest, opacity=opacity,
                 log_scale=log_scale, quat=quat),
            offset,
        )

    # ----------------------------------------------------------------- write
    def write(self, cloud: SplatCloud, path: str, **kwargs) -> None:
        comp = int(kwargs.get("compression_level", 0) or 0)
        bucket_size = int(kwargs.get("bucket_size") or 256)
        block_size = kwargs.get("block_size")

        c = cloud
        if comp >= 1 and c.n:
            # Morton order, so the buckets of consecutive rows are tight
            c = c.select(morton_order(c.pos))
        n = c.n

        centers = None
        if comp >= 1:
            centers = _bucket_centers(c.pos, bucket_size)
        if block_size is None:
            if comp >= 1:
                # the smallest block in which no bucket-relative offset
                # saturates (the reference hardcodes 5.0 and clips; the
                # section header carries the value)
                if not n:
                    max_off = 0.0
                elif c.is_host:
                    cidx = np.arange(n) // bucket_size
                    max_off = float(np.max(np.abs(c.pos - centers[cidx])))
                else:
                    cidx = torch.arange(n, device=c.pos.device) // bucket_size
                    max_off = float((c.pos - centers[cidx]).abs().amax())
                block_size = max(2.0 * max_off * 1.001, 1e-3)
            else:
                block_size = 5.0
        block_size = float(block_size)

        sh_degree = effective_sh_degree(c, kwargs, 2)
        req = kwargs.get("sh_level")
        if req is not None and int(req) < sh_degree:
            sh_degree = int(req)
        sh_count = _SH_COUNT[sh_degree]
        sh_dim = sh_count // 3
        min_sh, max_sh = -2.0, 2.0

        header = bytearray(HEADER_SIZE)
        header[0], header[1] = MAGIC_MAJOR, MAGIC_MINOR
        struct.pack_into("<I", header, 4, 1)
        struct.pack_into("<I", header, 8, 1)
        struct.pack_into("<I", header, 12, n)
        struct.pack_into("<I", header, 16, n)
        struct.pack_into("<H", header, 20, comp)
        struct.pack_into("<f", header, 36, min_sh)
        struct.pack_into("<f", header, 40, max_sh)

        full_buckets = n // bucket_size
        pfb = 1 if n % bucket_size else 0
        bucket_count = full_buckets + pfb
        rec = _record_dtype(comp, sh_count)

        sec = bytearray(SECTION_HEADER_SIZE)
        struct.pack_into("<I", sec, 0, n)
        struct.pack_into("<I", sec, 4, n)
        if comp >= 1:
            struct.pack_into("<I", sec, 8, bucket_size)
            struct.pack_into("<I", sec, 12, (n + bucket_size - 1) // bucket_size)
            struct.pack_into("<f", sec, 16, block_size)
            struct.pack_into("<H", sec, 20, 12)
            struct.pack_into("<I", sec, 24, SCALE_RANGE)
        storage = pfb * 4 + (bucket_count * 12 if comp >= 1 else 0) + n * rec.itemsize
        struct.pack_into("<I", sec, 28, storage)
        struct.pack_into("<I", sec, 32, full_buckets)
        struct.pack_into("<I", sec, 36, pfb)
        struct.pack_into("<H", sec, 40, sh_degree)

        sf_inv = SCALE_RANGE / (block_size / 2.0)
        # streamed encode: one reused chunk of records, written as it fills
        buf = np.zeros(min(STREAM_ROWS, max(n, 1)), rec)
        with open(path, "wb") as f:
            f.write(header)
            f.write(sec)
            if pfb:
                f.write(struct.pack("<I", n % bucket_size))
            if comp >= 1:
                f.write(to_host(centers).astype("<f4").tobytes())
            for s in range(0, n, STREAM_ROWS):
                e = min(s + STREAM_ROWS, n)
                out = buf[: e - s]
                for name, field in _encode_rows(c, s, e, comp, centers, bucket_size,
                                                sf_inv, sh_dim, min_sh, max_sh).items():
                    if name == "scale" and comp:
                        field = field.view(np.uint16)
                    out[name] = field
                f.write(memoryview(out))
        status_print(f"KSplat (Level {comp}) write completed. {n} points.")

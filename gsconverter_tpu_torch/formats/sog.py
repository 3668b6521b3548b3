"""PlayCanvas .sog codec — ZIP of lossless WebP textures + meta.json.

Container & quantization contract (reference formats/sog.py), as the JAX
package writes it:
  - texture dims width=ceil(sqrt(N)/4)*4, height=ceil(N/width/4)*4
  - splats in Morton order of their positions, for texture locality
  - positions: sign*log(|v|+1) -> min/max norm -> u16 -> lo/hi byte WebPs
  - quats: smallest-three u8x3, alpha = 252+max_idx (ops.quant.pack_rot_sog)
  - scales & sh0: 256-entry sorted scalar K-Means codebooks (fit on <=50k
    subsample), indices in RGB channels; sh0 alpha = sigmoid(opacity)*255
  - shN: chunked K-Means palette (target K by compression level: <=3 -> 64k,
    4-6 -> 16k, else 4k; floor 256), centroid values scalar-quantized into a
    256 codebook, 64-wide centroid index image + u16 label image; meta.json
    version 2.

Both residencies run the exact stages on a device, the writer's ``device``
for a host cloud (one ``upload`` stage copies its fields there) and the
tensors' own for a tensor cloud: the Morton order and the gathers by it,
the shN u8 pre-quantization and its dequantization, the palette fit
(``ops.kmeans.kmeans_chunked``, kernel K2 on the card, waited for only after
the host stages) and the nearest-codebook lookups.  Their 256-entry
codebooks are fitted on the host from a numpy-drawn subsample gathered
where the values live.  A host cloud's positions, rotations and opacity
come back gathered and are encoded in numpy on host threads; a tensor
cloud encodes them on its device.  (The JAX package's device
branch differs: it fits the palette on raw f32 values and the codebooks by
device K-Means.)  ``log1p``, ``exp`` and the square root of the rotation
norm may differ from numpy's by an ulp, moving a texel by one step, so a
host cloud's file is byte for byte the numpy encode's, a tensor cloud's
within those steps of it.  An empty cloud raises ``ValueError``: a
texture needs a pixel.
"""

from __future__ import annotations

import concurrent.futures as cf
import io
import json
import zipfile

import numpy as np
import torch

from ..cloud import COEFFS_FOR_DEGREE, SplatCloud
from ..config import resolve_device
from ..ops import quant
from ..ops.kmeans import kmeans_chunked
from ..ops.sh import effective_sh_degree
from ..parallel.mesh import is_writer
from ..utils.log import StageTimer, count, status_print
from ..utils.transfer import synchronize, to_host, upload, upload_fields
from .base import BaseFormat, register

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def _webp_bytes(flat_rgba: np.ndarray, w: int, h: int) -> bytes:
    # quality=0 selects the fastest LOSSLESS effort level (quality only
    # trades encode time for size in lossless mode)
    img = Image.frombytes("RGBA", (w, h), flat_rgba.tobytes())
    bio = io.BytesIO()
    img.save(bio, format="WEBP", lossless=True, quality=0, method=1)
    return bio.getvalue()


class _ImageBundle:
    """Encodes texture planes on background threads as they are added
    (libwebp releases the GIL), so the encodes overlap each other and the
    stages still running on the main thread.  Planes must not be mutated
    after ``add``.  ``flush`` writes the entries in add order, keeping the
    output bytes deterministic.  A context manager: leaving it, on success
    or on an error, cancels what has not started and joins the workers."""

    def __init__(self, zf: zipfile.ZipFile, width: int, height: int):
        self.zf = zf
        self.w, self.h = width, height
        self.ex = cf.ThreadPoolExecutor(4)
        self.futs: list[tuple[str, cf.Future]] = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.ex.shutdown(wait=True, cancel_futures=True)
        return False

    def add(self, name, rgba, w=None, h=None):
        self.futs.append(
            (name, self.ex.submit(_webp_bytes, rgba, w or self.w, h or self.h)))

    def flush(self):
        for name, fut in self.futs:
            self.zf.writestr(_zentry(name), fut.result())
        self.futs = []


def _zentry(name: str) -> zipfile.ZipInfo:
    """Fixed-timestamp ZipInfo: ``writestr`` with a bare name stamps the
    current time into the entry header, and reruns would differ."""
    return zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))


def _read_webp_flat(zf: zipfile.ZipFile, name: str, expected: int) -> np.ndarray:
    with zf.open(name) as f:
        img = Image.open(f)
        if img.mode != "RGBA":
            img = img.convert("RGBA")
        data = np.array(img).reshape(-1, 4)
    if len(data) < expected:
        raise ValueError(f"Image {name} too small: {len(data)} < {expected}")
    return data[:expected]


def _dequant_u8(q8: torch.Tensor, scale: float, mn: float) -> torch.Tensor:
    """u8 codes -> f32 values, ``q8 * scale + mn`` with f32 scale and min.

    Formed exactly in f64 and rounded once to f32: that is the fused
    multiply-add into which XLA's CPU backend contracts the JAX package's
    ``q8.astype(f32) * scale + mn``; two f32 roundings differ from it on
    about 40% of values.  Every later step sees these values.
    """
    s64 = float(np.float32(scale))
    m64 = float(np.float32(mn))
    return (q8.to(torch.float64) * s64 + m64).to(torch.float32)


def _codebook_sample(vals, seed: int) -> np.ndarray:
    """The codebook fit's <=50k subsample as host f32: indices drawn by
    numpy from ``seed``, gathered where ``vals`` lives (numpy or a tensor,
    whose 200 KB sample alone comes to the host)."""
    size = vals.numel() if isinstance(vals, torch.Tensor) else np.size(vals)
    idx = None
    if size > 50000:
        idx = np.random.default_rng(seed).choice(size, 50000, replace=False)
    if isinstance(vals, torch.Tensor):
        v = vals.reshape(-1)
        if idx is not None:
            v = v[upload(idx, v.device)]
        return to_host(v.to(torch.float32))
    v = np.asarray(vals, np.float32).reshape(-1)
    return v if idx is None else v[idx]


def _fit_scalar_codebook_host(vals, seed: int) -> np.ndarray:
    """Host 1-D Lloyd on a <=50k subsample: quantile init + searchsorted
    assignment + bincount update (256 sorted entries, empty clusters keep
    their previous centroid, fixed 20 iterations)."""
    fit = _codebook_sample(vals, seed)
    if fit.size == 0:
        return np.zeros(256, np.float32)
    fs = np.sort(fit)
    c = fs[np.linspace(0, fs.size - 1, 256).astype(np.int64)].astype(np.float64)
    for _ in range(20):
        c = np.sort(c)
        mid = (c[1:] + c[:-1]) * 0.5
        lab = np.searchsorted(mid, fit)
        sums = np.bincount(lab, weights=fit, minlength=256)
        cnt = np.bincount(lab, minlength=256)
        c = np.where(cnt > 0, sums / np.maximum(cnt, 1), c)
    return np.sort(c).astype(np.float32)


def morton_order(pos):
    """The writer's splat order: stable argsort of 10-bit-per-axis Morton
    codes of the positions normalized to their bounds.  numpy in, numpy out;
    a tensor in, an int64 order on its device out."""
    if isinstance(pos, torch.Tensor):
        mins3 = pos.amin(dim=0)
        rng3 = pos.amax(dim=0) - mins3
        t01 = (pos - mins3) / torch.where(rng3 > 0, rng3, 1.0)
        gq = (t01 * 1023.0).to(torch.int64)
        return torch.sort(quant.morton3_u32(gq[:, 0], gq[:, 1], gq[:, 2]),
                          stable=True).indices
    mins3 = pos.min(axis=0)
    rng3 = pos.max(axis=0) - mins3
    t01 = (pos - mins3) / np.where(rng3 > 0, rng3, 1.0)
    gq = (t01 * 1023.0).astype(np.uint32)
    return np.argsort(quant.morton3_u32(gq[:, 0], gq[:, 1], gq[:, 2]), kind="stable")


def palette_size(n: int, comp_level: int) -> tuple[int, int]:
    """(num_chunks, k_per_chunk) of the shN palette (reference sog.py:513-529)."""
    official_k = min(64, 2 ** int(np.floor(np.log2(max(n, 1024) / 1024)))) * 1024
    if comp_level <= 3:
        target_k = min(65536, official_k)
    elif comp_level <= 6:
        target_k = min(16384, official_k)
    else:
        target_k = min(4096, official_k)
    target_k = max(256, target_k)
    num_chunks = max(1, min(64, n // 1024))
    k_per_chunk = max(16, int(np.ceil(target_k / num_chunks)))
    # cap so palette labels stay u16
    return num_chunks, min(k_per_chunk, 65536 // num_chunks)


def shn_u8(rest_sl: np.ndarray, n: int, coeffs: int):
    """The shN u8 pre-quantization: (q8 [n, coeffs] u8, scale, min), bounds
    from a strided sample (u8 is below the format's own 256-codebook
    precision floor)."""
    if isinstance(rest_sl, torch.Tensor):
        return _shn_u8_torch(rest_sl, n, coeffs)
    samp = rest_sl[::97].astype(np.float32)
    shq_min = float(samp.min()) if samp.size else 0.0
    mx = float(samp.max()) if samp.size else 1.0
    shq_scale = (mx - shq_min) / 255.0 or 1.0
    # chunked: strided read + arithmetic + u8 store stay cache-resident
    q8 = np.empty((n, coeffs), np.uint8)
    inv = 1.0 / shq_scale
    for s in range(0, n, 262144):
        blk = rest_sl[s:s + 262144].reshape(-1, coeffs)
        q8[s:s + 262144] = np.clip((blk - shq_min) * inv + 0.5, 0, 255)
    return q8, shq_scale, shq_min


def _shn_u8_torch(rest_sl: torch.Tensor, n: int, coeffs: int):
    """``shn_u8`` on the device: the same bounds (two floats read back) and
    the same f32 steps, each a separate op so none is contracted."""
    lo, hi = torch.aminmax(rest_sl[::97].to(torch.float32))
    shq_min, mx = float(lo), float(hi)
    shq_scale = (mx - shq_min) / 255.0 or 1.0
    inv = 1.0 / shq_scale
    q8 = torch.empty((n, coeffs), dtype=torch.uint8, device=rest_sl.device)
    for s in range(0, n, 1 << 20):
        blk = rest_sl[s:s + (1 << 20)].reshape(-1, coeffs)
        q8[s:s + (1 << 20)] = torch.clamp((blk - shq_min) * inv + 0.5, 0, 255).to(torch.uint8)
    return q8, shq_scale, shq_min


def _codebook_indices(vals: torch.Tensor, seed: int, dev):
    """(the 256-entry codebook of ``vals``, each value's nearest entry as
    host u8): the codebook fitted on the host from its sample, the lookups
    where ``vals`` lives."""
    cb = _fit_scalar_codebook_host(vals, seed=seed)
    idx = quant.nearest_codebook_index(vals, upload(cb, dev))
    return cb, to_host(idx.to(torch.uint8))


def _dispatch_palette(rest_sl: torch.Tensor, order: torch.Tensor, n: int, coeffs: int,
                      num_chunks: int, k_per_chunk: int, dev, stage):
    """The stages ``shN_quant_u8`` and ``shN_fit_dispatch``: the shN u8
    pre-quantization of ``rest_sl`` [n, 3, coeffs // 3] in the splats'
    ``order``, dequantized, and the palette fit dispatched on its device
    (not waited for)."""
    with stage("shN_quant_u8"):
        q8, shq_scale, shq_min = shn_u8(rest_sl, n, coeffs)
        q8 = q8[order]
    with stage("shN_fit_dispatch"):
        status_print(
            f"SH Clustering: K={num_chunks * k_per_chunk}, Points={n}, "
            f"chunks={num_chunks} (batched K-Means on {dev.type})")
        return kmeans_chunked(_dequant_u8(q8, shq_scale, shq_min), num_chunks, k_per_chunk,
                              max_iter=10, seed=100)


@register
class SogFormat(BaseFormat):
    name = "sog"
    extension = ".sog"
    max_sh_degree = 3
    needs_rgb = True
    # the shN palette fit takes the sharded K-Means under a mesh
    collective_write = True

    # ----------------------------------------------------------------- read
    def read(self, path: str, **kwargs) -> SplatCloud:
        if Image is None:
            raise ImportError("Pillow is required to read .sog files.")
        if not zipfile.is_zipfile(path):
            raise ValueError("SOG Format: Only ZIP-bundled .sog files are supported.")
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.load(zf.open("meta.json"))
            n = meta["count"]

            ml = _read_webp_flat(zf, meta["means"]["files"][0], n)
            mu = _read_webp_flat(zf, meta["means"]["files"][1], n)
            q16 = ml[:, :3].astype(np.uint16) | (mu[:, :3].astype(np.uint16) << 8)
            mins = np.array(meta["means"]["mins"], np.float32)
            maxs = np.array(meta["means"]["maxs"], np.float32)
            logv = q16.astype(np.float32) / 65535.0 * (maxs - mins) + mins
            pos = np.sign(logv) * (np.exp(np.abs(logv)) - 1.0)

            sidx = _read_webp_flat(zf, meta["scales"]["files"][0], n)
            scb = np.array(meta["scales"]["codebook"], np.float32)
            log_scale = scb[sidx[:, :3]]

            qdata = _read_webp_flat(zf, meta["quats"]["files"][0], n)
            quat = quant.unpack_rot_sog(
                np.ascontiguousarray(qdata[:, :3]), np.ascontiguousarray(qdata[:, 3]))

            s0 = _read_webp_flat(zf, meta["sh0"]["files"][0], n)
            cb0 = np.array(meta["sh0"]["codebook"], np.float32)
            sh_dc = cb0[s0[:, :3]]
            opacity = quant.u8_to_logit_splat(np.ascontiguousarray(s0[:, 3]))

            sh_rest = np.zeros((n, 3, 15), np.float32)
            deg = 0
            if "shN" in meta:
                deg = int(meta["shN"]["bands"])
                count = int(meta["shN"]["count"])
                coeffs = COEFFS_FOR_DEGREE[deg]
                per_color = coeffs // 3
                w_c = 64 * coeffs
                h_c = int(np.ceil(count / 64))
                craw = _read_webp_flat(zf, meta["shN"]["files"][0], w_c * h_c)
                # palette entry i at row i//64, cols (i%64)*per_color + j;
                # RGB channels hold the per-channel codebook indices
                i = np.arange(count)
                pix = (i // 64)[:, None] * w_c + ((i % 64) * per_color)[:, None] \
                    + np.arange(per_color)[None, :]
                pal_idx = craw[pix.reshape(-1), :3].reshape(count, per_color, 3)
                cbN = np.array(meta["shN"]["codebook"], np.float32)
                palette = cbN[pal_idx].transpose(0, 2, 1).reshape(count, coeffs)

                lraw = _read_webp_flat(zf, meta["shN"]["files"][1], n)
                labels = lraw[:, 0].astype(np.uint16) | (lraw[:, 1].astype(np.uint16) << 8)
                sh_rest = SplatCloud.sh_rest_from_flat(palette[labels].astype(np.float32))

        return SplatCloud(
            pos=pos.astype(np.float32), sh_dc=sh_dc.astype(np.float32),
            sh_rest=sh_rest, opacity=opacity.astype(np.float32),
            log_scale=log_scale.astype(np.float32), quat=quat.astype(np.float32),
            normal=np.zeros((n, 3), np.float32),
            active_sh_degree=deg,
        )

    # ---------------------------------------------------------------- write
    def write(self, cloud: SplatCloud, path: str, device=None, **kwargs) -> None:
        """Write ``cloud`` to ``path``.  A host cloud's shN palette is fitted
        on ``device`` (default the card); a tensor cloud's stages run where
        its tensors live.  Under a multi-rank mesh every rank encodes (the
        palette fit is sharded over them) and rank 0 alone writes."""
        if Image is None:
            raise ImportError("Pillow is required to write .sog files.")
        n = cloud.n
        if n == 0:
            raise ValueError("SOG: cannot write an empty cloud (its textures "
                             "need at least one splat)")
        dev = resolve_device(device) if cloud.is_host else cloud.pos.device
        # the stages ``sog.<tag>``, kept on the handler as ``timer``; with
        # --timing each ends in a synchronize of a tensor cloud's device (its
        # own device time) and prints its line
        self.timer = timer = StageTimer()

        def stage(tag):
            return timer.stage(f"sog.{tag}", digits=0,
                               sync=None if cloud.is_host else lambda: synchronize(dev))

        with stage("detect_bands"):
            width = int(np.ceil(np.sqrt(n) / 4) * 4)
            height = int(np.ceil(n / width / 4) * 4)
            npix = width * height
            sh_bands = effective_sh_degree(cloud, kwargs, 3)

        # palette sizing first, so the device fit can be dispatched before
        # the host stages and run while they do
        comp_level = int(kwargs.get("compression_level", 0) or 0)
        num_chunks = k_per_chunk = 0
        if sh_bands > 0:
            num_chunks, k_per_chunk = palette_size(n, comp_level)
        encode = self._encode_host if cloud.is_host else self._encode_tensor
        (u16, mins, maxs, q_u8, q_alpha, scale_cb, scl_idx, color_cb, dc_idx,
         op_u8, fit) = encode(cloud, n, sh_bands, num_chunks, k_per_chunk, dev, stage)
        if not is_writer():
            return

        with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf, \
                _ImageBundle(zf, width, height) as bundle:
            with stage("texture_imgs"):
                self._write_textures(bundle, npix, n, u16, q_u8, q_alpha, scl_idx,
                                     dc_idx, op_u8)
            shN_meta = labels = None
            if sh_bands > 0:
                shN_meta, labels = self._write_palette(bundle, fit, sh_bands, comp_level, stage)
            with stage("labels+meta"):
                if labels is not None:
                    labels_img = np.zeros((npix, 4), np.uint8)
                    labels_img[:n, 0] = (labels & 0xFF).astype(np.uint8)
                    labels_img[:n, 1] = (labels >> 8).astype(np.uint8)
                    labels_img[:n, 3] = 255
                    bundle.add("shN_labels.webp", labels_img)
                meta = {
                    "version": 2,
                    "asset": {"generator": "gsconverter-tpu-sog"},
                    "count": n,
                    "means": {
                        "mins": [float(x) for x in np.asarray(mins)],
                        "maxs": [float(x) for x in np.asarray(maxs)],
                        "files": ["means_l.webp", "means_u.webp"],
                    },
                    "scales": {
                        "codebook": [float(x) for x in scale_cb],
                        "files": ["scales.webp"],
                    },
                    "quats": {"files": ["quats.webp"]},
                    "sh0": {
                        "codebook": [float(x) for x in color_cb],
                        "files": ["sh0.webp"],
                    },
                }
                if shN_meta:
                    meta["shN"] = shN_meta
            with stage("webp_flush"):
                bundle.flush()  # concurrent WebP encodes, then zip entries
            zf.writestr(_zentry("meta.json"), json.dumps(meta))
        status_print(f"SOG write completed to {path}. {n} points bundled.")

    @staticmethod
    def _encode_host(cloud, n, sh_bands, num_chunks, k_per_chunk, dev, stage):
        """Host cloud: its fields go to ``dev`` once, and there the Morton
        order, the gathers by it, the shN u8 pre-quantization, the palette
        fit and the scale and sh0 codebook lookups run.  The positions,
        rotations and opacity, whose torch twins may differ from numpy by an
        ulp, come back gathered and are encoded in numpy on a 2-thread host
        pool."""
        coeffs0 = COEFFS_FOR_DEGREE[sh_bands] if sh_bands > 0 else 0
        with stage("upload"):
            fields = {"pos": cloud.pos, "log_scale": cloud.log_scale, "sh_dc": cloud.sh_dc,
                      "quat": cloud.quat, "opacity": cloud.opacity}
            if sh_bands > 0:
                # degree-packed channel-major [R0..Rp-1, G0.., B0..]
                fields["rest"] = np.asarray(cloud.sh_rest)[:, :, :coeffs0 // 3]
            on_dev = upload_fields(fields, dev)
            copied = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                      for t in on_dev.values()}
            count(upload_bytes=sum(copied.values()))
        with stage("morton_order"):
            order = morton_order(on_dev["pos"])

        def gathered(name, rows=slice(None)):
            return to_host(on_dev[name][order[rows]])

        # the numpy encodes run on a 2-worker pool (numpy releases the GIL),
        # and so do the codebook fits from their samples, while the main
        # thread quantizes shN and dispatches the palette fit
        def enc_pos():
            p = gathered("pos")
            lp = np.copysign(np.log1p(np.abs(p)), p)
            mins = lp.min(axis=0)
            maxs = lp.max(axis=0)
            rng = np.where(maxs - mins > 0, maxs - mins, 1.0)
            u16 = np.clip((lp - mins) / rng * 65535.0, 0, 65535).astype(np.uint16)
            return u16, mins, maxs

        def enc_quat(rows):
            return quant.pack_rot_sog(gathered("quat", rows))

        def enc_scales():
            return _codebook_indices(on_dev["log_scale"][order], 1, dev)

        def enc_sh0():
            cb, idx = _codebook_indices(on_dev["sh_dc"][order], 2, dev)
            op = np.clip(quant.sigmoid(gathered("opacity")) * 255.0, 0, 255).astype(np.uint8)
            return cb, idx, op

        status_print("Clustering Scales...")
        status_print("Clustering Colors...")
        fit = None
        # the rotations, the longest encode, in two halves of the rows (each
        # row's bytes are its own), one on each worker first
        half = n // 2
        with cf.ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(enc_quat, slice(0, half)), pool.submit(enc_quat, slice(half, n))]
            futs += [pool.submit(f) for f in (enc_pos, enc_scales, enc_sh0)]
            try:
                if sh_bands > 0:
                    fit = _dispatch_palette(on_dev["rest"], order, n, coeffs0, num_chunks,
                                            k_per_chunk, dev, stage)
                with stage("encode_threads_join"):
                    q_u8, q_alpha = (np.concatenate(a) for a in zip(futs[0].result(),
                                                                   futs[1].result()))
                    u16, mins, maxs = futs[2].result()
                    scale_cb, scl_idx = futs[3].result()
                    color_cb, dc_idx, op_u8 = futs[4].result()
            except BaseException:
                for f in futs:
                    f.cancel()
                raise
        return (u16, mins, maxs, q_u8, q_alpha, scale_cb, scl_idx, color_cb, dc_idx,
                op_u8, fit)

    @staticmethod
    def _encode_tensor(cloud, n, sh_bands, num_chunks, k_per_chunk, dev, stage):
        """Tensor cloud: every stage on its device, the host branch's
        arithmetic; the textures' bytes, the bounds and the codebook samples
        come to the host."""
        with stage("morton_order"):
            order = morton_order(cloud.pos.to(torch.float32))
        with stage("positions"):
            p = cloud.pos[order]
            lp = torch.copysign(torch.log1p(p.abs()), p)
            mins, maxs = torch.aminmax(lp, dim=0)
            rng = torch.where(maxs - mins > 0, maxs - mins, 1.0)
            u16 = torch.clamp((lp - mins) / rng * 65535.0, 0, 65535).to(torch.int32)
            u16 = to_host(u16).astype(np.uint16)
            mins, maxs = to_host(mins), to_host(maxs)
        with stage("rotations"):
            q_u8, q_alpha = (to_host(a) for a in quant.pack_rot_sog(cloud.quat[order]))
        with stage("scalar_codebooks"):
            status_print("Clustering Scales...")
            status_print("Clustering Colors...")
            scale_cb, scl_idx = _codebook_indices(cloud.log_scale[order], 1, dev)
            color_cb, dc_idx = _codebook_indices(cloud.sh_dc[order], 2, dev)
            op_u8 = torch.clamp(quant.sigmoid(cloud.opacity[order]) * 255.0, 0, 255)
            op_u8 = to_host(op_u8.to(torch.uint8))
        fit = None
        if sh_bands > 0:
            coeffs0 = COEFFS_FOR_DEGREE[sh_bands]
            # degree-packed channel-major [R0..Rp-1, G0.., B0..]
            fit = _dispatch_palette(cloud.sh_rest[:, :, :coeffs0 // 3], order, n, coeffs0,
                                    num_chunks, k_per_chunk, dev, stage)
        return (u16, mins, maxs, q_u8, q_alpha, scale_cb, scl_idx, color_cb, dc_idx,
                op_u8, fit)

    @staticmethod
    def _write_textures(bundle, npix, n, u16, q_u8, q_alpha, scl_idx, dc_idx, op_u8):
        means_l = np.full((npix, 4), 255, np.uint8)
        means_u = np.full((npix, 4), 255, np.uint8)
        means_l[:n, :3] = (u16 & 0xFF).astype(np.uint8)
        means_u[:n, :3] = (u16 >> 8).astype(np.uint8)
        bundle.add("means_l.webp", means_l)
        bundle.add("means_u.webp", means_u)

        quats = np.full((npix, 4), 255, np.uint8)
        quats[:n, :3] = q_u8
        quats[:n, 3] = q_alpha
        bundle.add("quats.webp", quats)

        scales_img = np.zeros((npix, 4), np.uint8)
        scales_img[:n, :3] = scl_idx
        scales_img[:n, 3] = 255
        bundle.add("scales.webp", scales_img)

        sh0_img = np.zeros((npix, 4), np.uint8)
        sh0_img[:n, :3] = dc_idx
        sh0_img[:n, 3] = op_u8
        bundle.add("sh0.webp", sh0_img)

    @staticmethod
    def _write_palette(bundle, fit, sh_bands, comp_level, stage):
        """The shN centroids' image (their codebook's sample and lookups
        where the fit left them); returns the palette's meta entry and the
        splats' palette ids (their image is the writer's)."""
        coeffs = COEFFS_FOR_DEGREE[sh_bands]
        per_color = coeffs // 3
        with stage("shN_fit+centroids_pull"):
            status_print(f"SOG Write Quality Level: {comp_level} (0=Max, 9=Min)")
            # the first wait for the device: the fit was dispatched before the
            # host stages above
            centroids, l = fit
            synchronize(centroids.device)
        with stage("shN_labels_pull"):
            labels = to_host(l).astype(np.uint16)  # palette ids fit u16
        with stage("shN_codebook_imgs"):
            count = len(centroids)
            status_print("Clustering SH Centroids into Codebook...")
            cbN, cent_idx = _codebook_indices(centroids.reshape(-1), 3, centroids.device)

            # centroid-index image: [P, coeffs] channel-major -> [P, per_color, 3]
            # pixels laid out 64 palette entries per row
            w_c = 64 * coeffs
            h_c = int(np.ceil(count / 64))
            cent_img = np.full((w_c * h_c, 4), 255, np.uint8)
            per_pal = cent_idx.reshape(count, 3, per_color).transpose(0, 2, 1)
            i = np.arange(count)
            pix = (i // 64)[:, None] * w_c + ((i % 64) * per_color)[:, None] \
                + np.arange(per_color)[None, :]
            cent_img[pix.reshape(-1), :3] = per_pal.reshape(-1, 3)
            bundle.add("shN_centroids.webp", cent_img, w_c, h_c)
        return {
            "count": int(count),
            "bands": int(sh_bands),
            "codebook": [float(x) for x in cbN],
            "files": ["shN_centroids.webp", "shN_labels.webp"],
        }, labels

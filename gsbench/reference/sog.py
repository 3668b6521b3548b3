"""Plain reference of the PlayCanvas ``.sog`` files the port writes.

The format (PlayCanvas's splat-transform; the port's ``formats/sog.py``
states the contract it writes): a zip of lossless WebP planes and a
``meta.json`` of version 2.  Every plane is ``width = ceil(sqrt(n) / 4) 4``
texels wide and ``height = ceil(n / width / 4) 4`` high, and texel i holds
the i-th splat of the Morton order:

- Morton order: each position normalized to the cloud's bounds in float32,
  ``(p - min) / (max - min)`` (a flat axis divides by 1), times 1023,
  truncated to 10 bits an axis; x in the lowest bit of each triple; a
  stable sort, so tied codes keep their source order.
- positions: ``sign(p) log(1 + |p|)``, normalized to its own bounds
  (``means.mins`` / ``maxs``), times 65535 and truncated to u16, low and
  high bytes in two planes.
- rotations: the unit quaternion (w, x, y, z) turned so that its largest
  component (the first on a tie) is positive; the other three, in index
  order, times sqrt(2), stored as ``(v / 2 + 1 / 2) 255`` truncated, and
  ``252 + index`` of the largest as the fourth byte.
- scales and sh0: sorted 256-entry scalar codebooks (a 1-D Lloyd fit of 20
  steps from quantile seeds on at most 50,000 sampled values), each texel
  the index of its value's nearest entry; the opacity byte is
  ``sigmoid(logit) 255`` truncated, in sh0's fourth channel.
- shN: a chunked palette.  The compression level sets the palette's size
  (levels up to 3: up to 65,536 entries, 4-6: 16,384, above: 4,096, floor
  256, and never more than 1024 per 1024 splats rounded down to a power of
  two), spread over ``min(64, n // 1024)`` chunks (at least 1) of
  ``ceil(size / chunks)`` entries each (at least 16, at most 65536 over the
  chunks).  Chunk c holds the splats of rows ``[c R, (c + 1) R)`` of the
  Morton order, R the least power-of-two multiple of ``max(256, k)`` that is
  at least ``ceil(n / chunks)``, so trailing chunks may hold none; a splat's
  label is an entry of its own chunk (ids ``[c k, (c + 1) k)``).  The
  entries' values are stored as indices into one 256-entry codebook, 64
  entries a row of the centroid plane (the entry i % 64 of row i // 64 at
  texels ``(i % 64) per`` on, ``per`` texels an entry, the rest of the
  row unused), an entry's j-th texel holding its j-th coefficient of red,
  green and blue; labels are u16 over two channels of the label plane.
- A texel whose alpha is 0 keeps no color: lossless WebP without its exact
  mode may rewrite the RGB under alpha 0, so a splat whose opacity byte is
  0 has no sh0 index in the file.

``expected`` is this module's own encode of a scene in that order: the
same quantities in float64 where the format rounds in float32, a palette
fitted by a plain chunked Lloyd (the same chunks and k, its own seeded
k-means++ init, 10 steps, in float32 with TF32 off, on the given device in
blocks), whose centroids it quantizes with its own 256-entry codebook.
``decode`` reads a file into the same fields, and ``compare`` holds a
decoded file (or the encode of a bfloat16 scene, the control) against the
scene texel by texel in the reference's own Morton order.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import zipfile

import numpy as np
import torch
from PIL import Image

SQRT2 = math.sqrt(2.0)
CODEBOOK = 256
CODEBOOK_SAMPLE = 50_000
CODEBOOK_STEPS = 20
LLOYD_STEPS = 10
TIE = 1e-6  # a value this close to a midpoint between two entries may take either
BLOCK_ELEMS = 1 << 27  # bound on a [chunks, rows, k] block of the fit


# ------------------------------------------------------------------ layout


def palette_layout(n: int, level: int) -> tuple[int, int, int]:
    """(chunks, entries a chunk, rows a chunk) of the shN palette."""
    size = min(64, 2 ** int(math.floor(math.log2(max(n, 1024) / 1024)))) * 1024
    size = min(65536 if level <= 3 else 16384 if level <= 6 else 4096, size)
    size = max(256, size)
    chunks = max(1, min(64, n // 1024))
    k = min(max(16, -(-size // chunks)), 65536 // chunks)
    rows = max(256, k)
    while rows < -(-n // chunks):
        rows *= 2
    return chunks, k, rows


# ------------------------------------------------------------------ encode


def morton_order(pos) -> np.ndarray:
    pos = np.asarray(pos, np.float32)
    lo = pos.min(axis=0)
    span = pos.max(axis=0) - lo
    t = (pos - lo) / np.where(span > 0, span, np.float32(1.0))
    g = (t * np.float32(1023.0)).astype(np.int64)
    code = np.zeros(len(pos), np.int64)
    for bit in range(10):
        for axis in range(3):
            code |= ((g[:, axis] >> bit) & 1) << (3 * bit + axis)
    return np.argsort(code, kind="stable")


def log_positions(pos) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(u16 [n, 3] as int64, mins, maxs) of positions in texel order."""
    p = np.asarray(pos, np.float64)
    lp = np.sign(p) * np.log1p(np.abs(p))
    mins, maxs = lp.min(axis=0), lp.max(axis=0)
    span = np.where(maxs > mins, maxs - mins, 1.0)
    return np.floor(np.clip((lp - mins) / span * 65535.0, 0, 65535)).astype(np.int64), mins, maxs


def smallest_three(quat) -> np.ndarray:
    """[n, 4] bytes (three components and 252 + the largest's index)."""
    q32 = np.asarray(quat, np.float32)
    big = np.argmax(np.abs(q32), axis=1)
    q = q32.astype(np.float64)
    lead = np.take_along_axis(q, big[:, None], axis=1)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    q = q * np.where(lead >= 0, SQRT2, -SQRT2)
    slots = np.arange(3)[None, :]
    rest = np.take_along_axis(q, slots + (slots >= big[:, None]), axis=1)
    out = np.empty((len(q), 4), np.int64)
    out[:, :3] = np.floor(np.clip((rest * 0.5 + 0.5) * 255.0, 0, 255))
    out[:, 3] = 252 + big
    return out


def opacity_bytes(logit) -> np.ndarray:
    a = 1.0 / (1.0 + np.exp(-np.asarray(logit, np.float64)))
    return np.floor(np.clip(a * 255.0, 0, 255)).astype(np.int64)


def scalar_codebook(vals, seed: int) -> np.ndarray:
    """A sorted 256-entry codebook of ``vals`` (float32)."""
    v = np.asarray(vals, np.float32).reshape(-1)
    if v.size > CODEBOOK_SAMPLE:
        v = v[np.random.default_rng(seed).choice(v.size, CODEBOOK_SAMPLE, replace=False)]
    v = np.sort(v).astype(np.float64)
    c = v[np.linspace(0, v.size - 1, CODEBOOK).astype(np.int64)]
    for _ in range(CODEBOOK_STEPS):
        c = np.sort(c)
        lab = np.searchsorted((c[1:] + c[:-1]) * 0.5, v)
        cnt = np.bincount(lab, minlength=CODEBOOK)
        c = np.where(cnt > 0, np.bincount(lab, weights=v, minlength=CODEBOOK)
                     / np.maximum(cnt, 1), c)
    return np.sort(c).astype(np.float32)


def nearest_gap(vals, codebook) -> tuple[np.ndarray, np.ndarray]:
    """(the distance of each value to its nearest codebook entry, that
    entry's index in the sorted codebook), in float64."""
    v = np.asarray(vals, np.float64)
    cb = np.sort(np.asarray(codebook, np.float64))
    hi = np.clip(np.searchsorted(cb, v), 1, len(cb) - 1) if len(cb) > 1 \
        else np.zeros(v.shape, np.int64)
    lo = np.maximum(hi - 1, 0)
    dlo, dhi = np.abs(v - cb[lo]), np.abs(v - cb[hi])
    return np.minimum(dlo, dhi), np.where(dlo <= dhi, lo, hi)


@contextlib.contextmanager
def _no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _blocks(used: int, rows: int, k: int):
    step = max(1, min(rows, BLOCK_ELEMS // max(1, used * k)))
    return [(s, min(s + step, rows)) for s in range(0, rows, step)]


def _nearest(xt, cent, spans):
    """Each row's nearest centroid of its chunk, [used, rows] int64."""
    c2 = (cent * cent).sum(-1)[:, None, :]
    return torch.cat([(c2 - 2.0 * torch.bmm(xt[:, s:e], cent.transpose(1, 2))).argmin(-1)
                      for s, e in spans], dim=1)


def palette_fit(x, chunks: int, k: int, rows: int, seed: int, device,
                steps: int = LLOYD_STEPS) -> tuple[np.ndarray, np.ndarray]:
    """A plain chunked Lloyd fit of ``x`` [n, D] (float32, texel order):
    (centroids [chunks k, D], labels [n] offset by chunk k) on the host.
    Each chunk that holds rows draws its init by k-means++ (one centroid a
    step, the uniforms from a CPU generator seeded with ``seed``); an
    empty cluster keeps its centroid; sums by a one-hot product."""
    x = torch.as_tensor(np.ascontiguousarray(x, np.float32))
    n, d = x.shape
    used = -(-n // rows)
    xt = torch.zeros(used * rows, d)
    xt[:n] = x
    xt = xt.view(used, rows, d).to(device)
    nv = torch.clamp(n - torch.arange(used) * rows, max=rows).to(device)
    valid = torch.arange(rows, device=device)[None, :] < nv[:, None]
    u = torch.rand(used, k, generator=torch.Generator().manual_seed(int(seed)),
                   dtype=torch.float64).to(device)
    pick = torch.arange(used, device=device)
    spans = _blocks(used, rows, k)
    with _no_tf32():
        cent = torch.zeros(used, k, d, device=device)
        first = torch.clamp((u[:, 0] * nv).long(), max=rows - 1)
        cent[:, 0] = xt[pick, first]
        d2 = torch.where(valid, ((xt - cent[:, :1]) ** 2).sum(-1), 0.0)
        for j in range(1, k):
            cdf = torch.cumsum(d2.double(), dim=1)
            at = torch.searchsorted(cdf, (u[:, j] * cdf[:, -1])[:, None], right=True)[:, 0]
            at = torch.minimum(at, nv - 1)
            cent[:, j] = xt[pick, at]
            d2 = torch.where(valid, torch.minimum(d2, ((xt - cent[:, j:j + 1]) ** 2).sum(-1)),
                             0.0)
        for _ in range(steps):
            labels = _nearest(xt, cent, spans)
            sums = torch.zeros(used, k, d, device=device)
            counts = torch.zeros(used, k, device=device)
            for s, e in spans:
                hot = torch.nn.functional.one_hot(labels[:, s:e], k).float()
                hot = hot * valid[:, s:e, None]
                sums += torch.bmm(hot.transpose(1, 2), xt[:, s:e])
                counts += hot.sum(1)
            cent = torch.where(counts[..., None] > 0,
                               sums / torch.clamp(counts, min=1.0)[..., None], cent)
        labels = _nearest(xt, cent, spans) + (pick * k)[:, None]
    out = np.zeros((chunks * k, d), np.float32)
    out[:used * k] = cent.reshape(used * k, d).cpu().numpy()
    return out, labels.reshape(-1)[:n].cpu().numpy()


def expected(host: dict, level: int, sh_degree: int, seed: int, device) -> dict:
    """The reference's own encode of a scene (host float32 arrays ``pos``,
    ``quat``, ``log_scale``, ``sh_dc``, ``opacity``, ``sh_rest`` [n, 3, 15]):
    the fields ``decode`` gives, in its own texel order, and the scene's
    values in that order (``source``)."""
    n = len(host["pos"])
    order = morton_order(host["pos"])
    per = (sh_degree + 1) ** 2 - 1
    src = {k: np.asarray(host[k])[order] for k in ("pos", "quat", "log_scale", "sh_dc",
                                                    "opacity")}
    src["shn"] = np.asarray(host["sh_rest"])[order, :, :per].reshape(n, 3 * per)
    u16, mins, maxs = log_positions(src["pos"])
    scale_cb = scalar_codebook(src["log_scale"], seed + 1)
    sh0_cb = scalar_codebook(src["sh_dc"], seed + 2)
    out = {"count": n, "u16": u16, "mins": mins, "maxs": maxs,
           "quats": smallest_three(src["quat"]),
           "scale_cb": scale_cb, "scale_idx": nearest_gap(src["log_scale"], scale_cb)[1],
           "sh0_cb": sh0_cb, "sh0_idx": nearest_gap(src["sh_dc"], sh0_cb)[1],
           "opacity": opacity_bytes(src["opacity"]), "source": src}
    if per:
        chunks, k, rows = palette_layout(n, level)
        cent, labels = palette_fit(src["shn"], chunks, k, rows, seed, device)
        used = cent[:-(-n // rows) * k]
        cb = scalar_codebook(used, seed + 3)
        out["palette"] = np.sort(cb)[nearest_gap(cent, cb)[1]].astype(np.float32)
        out["labels"] = labels
    return out


# ------------------------------------------------------------------ decode


def _image(zf: zipfile.ZipFile, name: str) -> np.ndarray:
    """A plane as [height, width, 4] texels."""
    with Image.open(io.BytesIO(zf.read(name))) as img:
        return np.asarray(img.convert("RGBA")).astype(np.int64)


def _plane(zf: zipfile.ZipFile, name: str, count: int) -> np.ndarray:
    data = _image(zf, name).reshape(-1, 4)
    if len(data) < count:
        raise ValueError(f"{name}: {len(data)} texels for {count} splats")
    return data[:count]


def decode(path) -> dict:
    """A ``.sog`` file's fields, texel by texel."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
        n = int(meta["count"])
        lo, hi = (_plane(zf, f, n) for f in meta["means"]["files"])
        sh0 = _plane(zf, meta["sh0"]["files"][0], n)
        out = {"count": n, "u16": lo[:, :3] | (hi[:, :3] << 8),
               "mins": np.asarray(meta["means"]["mins"], np.float64),
               "maxs": np.asarray(meta["means"]["maxs"], np.float64),
               "quats": _plane(zf, meta["quats"]["files"][0], n),
               "scale_cb": np.asarray(meta["scales"]["codebook"], np.float32),
               "scale_idx": _plane(zf, meta["scales"]["files"][0], n)[:, :3],
               "sh0_cb": np.asarray(meta["sh0"]["codebook"], np.float32),
               "sh0_idx": sh0[:, :3], "opacity": sh0[:, 3]}
        if "shN" in meta:
            count, per = int(meta["shN"]["count"]), (int(meta["shN"]["bands"]) + 1) ** 2 - 1
            cent = _image(zf, meta["shN"]["files"][0])
            if cent.shape[0] * 64 < count or cent.shape[1] < 64 * per:
                raise ValueError(f"the centroid plane {cent.shape[:2]} holds no {count} entries")
            i = np.arange(count)
            codes = cent[(i // 64)[:, None], ((i % 64) * per)[:, None] + np.arange(per), :3]
            cb = np.asarray(meta["shN"]["codebook"], np.float32)
            out["palette"] = cb[codes.transpose(0, 2, 1).reshape(count, 3 * per)]
            lab = _plane(zf, meta["shN"]["files"][1], n)
            out["labels"] = lab[:, 0] | (lab[:, 1] << 8)
    return out


# ----------------------------------------------------------------- compare


def compare(got: dict, ref: dict, level: int) -> dict:
    """The compared numbers of ``got`` (``decode``'s fields, or another
    encode's) against the reference's encode ``ref`` of the same scene."""
    n = ref["count"]
    has_shn = "labels" in ref
    gap = abs(got["count"] - n)
    if has_shn:
        gap += abs(len(got.get("palette", ())) - len(ref["palette"]))
    m = min(got["count"], n)
    src = ref["source"]
    # positions: the texels' u16 and the stored bounds, in steps
    step = np.where(ref["maxs"] > ref["mins"], ref["maxs"] - ref["mins"], 1.0) / 65535.0
    bounds = max(np.abs(np.asarray(got["mins"], np.float64) - ref["mins"]).max(),
                 np.abs(np.asarray(got["maxs"], np.float64) - ref["maxs"]).max(initial=0.0))
    pos_steps = max(float(np.abs(got["u16"][:m] - ref["u16"][:m]).max(initial=0)),
                    float(bounds / step.min()))
    # rotations: a wrong index byte is as far off as a byte can be
    quat_steps = float(np.abs(got["quats"][:m, :3] - ref["quats"][:m, :3]).max(initial=0))
    if np.any(got["quats"][:m, 3] != ref["quats"][:m, 3]):
        quat_steps = 255.0
    misses = 0
    # sh0's indices of a splat whose opacity byte is 0 are not stored
    for key, vals, kept in (("scale", src["log_scale"], slice(None)),
                            ("sh0", src["sh_dc"], ref["opacity"][:m] > 0)):
        cb = np.asarray(got[f"{key}_cb"], np.float64)
        idx = np.clip(got[f"{key}_idx"][:m], 0, len(cb) - 1)
        best, _ = nearest_gap(vals[:m], cb)
        miss = (np.abs(vals[:m].astype(np.float64) - cb[idx]) > best + TIE) \
            | (got[f"{key}_idx"][:m] >= len(cb))
        misses += int(miss[kept].sum())
    numbers = {"count_gap": float(gap), "pos_steps": pos_steps, "quat_steps": quat_steps,
               "codebook_misses": float(misses),
               "opacity_steps": float(np.abs(got["opacity"][:m] - ref["opacity"][:m])
                                      .max(initial=0))}
    if has_shn:
        chunks, k, rows = palette_layout(n, level)
        labels = np.asarray(got.get("labels", np.full(m, -1)))[:m].astype(np.int64)
        chunk = np.arange(m) // rows
        numbers["shn_chunk_violations"] = float(((labels < chunk * k)
                                                 | (labels >= (chunk + 1) * k)).sum())
        pal = np.asarray(got.get("palette", np.zeros((1, src["shn"].shape[1]), np.float32)))
        recon = pal[np.clip(labels, 0, len(pal) - 1)].astype(np.float64)
        err = float(((recon - src["shn"][:m]) ** 2).mean())
        numbers["shn_distortion_ratio"] = err / ref_distortion(ref)
    return numbers


def ref_distortion(ref: dict) -> float:
    """The reference palette's mean squared shN error over the scene."""
    if "distortion" not in ref:
        recon = ref["palette"][ref["labels"]].astype(np.float64)
        ref["distortion"] = float(((recon - ref["source"]["shn"]) ** 2).mean())
    return ref["distortion"]

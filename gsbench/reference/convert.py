"""Plain reference of the conversion's filter chain and of the files it writes.

The filters follow the upstream 3dgsconverter's semantics (its README's
flags, ``processing/data_processor.py``), in the order bbox, alpha,
density, SOR, each keeping the surviving rows in their order:

- bbox: min <= pos <= max on every axis.
- alpha: logit opacity >= logit(clip(min_opacity / 255, 1e-6, 1 - 1e-6)).
- density: voxels of size max(0.1, 2 - 1.8 s) at floor(pos / voxel);
  those holding at least int((0.1 + 0.9 s) / 100 * n) points are dense;
  6-connected dense voxels form clusters; the largest by voxel count (the
  first in voxel order on a tie) is kept.
- SOR: k = int(10 + 40 (i - 1) / 9) neighbours, sigma = 20 - 17 (i - 1) / 9;
  each point's mean distance to its k nearest others among the candidates
  of its Morton window (rows of a 30-bit Morton order over the points'
  bounding box, in blocks of 512, each block's rows and ``window`` rows on
  either side; fewer than k found fill at the largest found); kept where
  that mean is under mean + sigma * std over all points.  Distances and
  statistics here are exact (float64); the port's are approximate (its
  kernel K1 rounds distances to bfloat16 and finds the k-th by
  bisection), so a row whose exact mean lies within a stated band of the
  threshold may fall either side, and the comparisons leave it out.
- .splat: 32-byte records (pos f32 x3, exp(log_scale) f32 x3, linear
  RGB u8 x3 = (0.5 + C0 dc) 255, alpha u8 = sigmoid 255, the normalized
  quaternion as u8 = 128 q + 128), sorted by exp(sum log_scale) sigmoid
  descending.
- .spz (version 3): gzip around a 16-byte header and planar sections:
  24-bit fixed-point positions (12 fractional bits), alpha, color
  (0.15 dc + 0.5) and scale ((log_scale + 10) 16) bytes, the rotation as
  its three smaller components (9 bits and a sign each) and the index of
  the largest, and SH bytes (128 v + 128, snapped to 5 bits for degree 1,
  4 above), rows in source order.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

SH_C0 = 0.28209479177387814
PAD = 1e15
SPLAT = np.dtype([("pos", "<f4", (3,)), ("scale", "<f4", (3,)), ("color", "u1", (4,)),
                  ("rot", "u1", (4,))])


def bbox_mask(pos, bbox):
    lo, hi = np.asarray(bbox[:3], np.float32), np.asarray(bbox[3:], np.float32)
    return np.all((pos >= lo) & (pos <= hi), axis=1)


def alpha_mask(opacity, min_opacity):
    t = np.clip(min_opacity / 255.0, 1e-6, 1.0 - 1e-6)
    return opacity >= float(np.log(t / (1.0 - t)))


def density_mask(pos, sensitivity):
    voxel = max(0.1, 2.0 - sensitivity * 1.8)
    threshold = 0.1 + sensitivity * 0.9
    n = pos.shape[0]
    cells = np.floor(pos.astype(np.float32) / np.float32(voxel)).astype(np.int64)
    uniq, inverse, counts = np.unique(cells, axis=0, return_inverse=True, return_counts=True)
    dense = counts >= int(threshold / 100.0 * n)
    index = {tuple(c): i for i, c in enumerate(uniq.tolist()) if dense[i]}
    label = np.full(len(uniq), -1)
    best, best_size = -1, 0
    steps = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
    for i in np.flatnonzero(dense):  # voxel order: the first cluster wins ties
        if label[i] >= 0:
            continue
        label[i], size, todo = i, 0, collections.deque([i])
        while todo:
            j = todo.popleft()
            size += 1
            x, y, z = uniq[j]
            for dx, dy, dz in steps:
                k = index.get((x + dx, y + dy, z + dz))
                if k is not None and label[k] < 0:
                    label[k] = i
                    todo.append(k)
        if size > best_size:
            best, best_size = i, size
    return (label[inverse.reshape(-1)] == best) & (best >= 0)


def sor_settings(intensity):
    k = min(int(10 + (intensity - 1) * (40 / 9)), 50)
    sigma = 20.0 - (intensity - 1) * (17.0 / 9)
    window = 128
    while window < 8 * k:
        window *= 2
    return k, sigma, max(window, 256)


def _morton(g):
    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0xFF0000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return (spread(g[:, 2]) << 2) | (spread(g[:, 1]) << 1) | spread(g[:, 0])


def sor_mean_dists(pos, k, window, device, block=512):
    """Each point's mean distance to its k nearest others among its Morton
    window's candidates (float64), and the number of (point, candidate)
    pairs the windows hold."""
    n = pos.shape[0]
    p = torch.from_numpy(np.ascontiguousarray(pos, np.float32)).to(device)
    lo, hi = p.amin(0), p.amax(0)
    rng = torch.where(hi > lo, hi - lo, 1.0)
    g = (torch.clamp((p - lo) / rng, 0.0, 1.0) * 511.0).to(torch.int64)
    order = torch.sort(_morton(g), stable=True).indices
    size = -(-n // block) * block
    sp = torch.full((size + 2 * window, 3), PAD, dtype=torch.float64, device=device)
    sp[window:window + n] = p[order].double()
    md = torch.empty(n, dtype=torch.float64, device=device)
    pairs = 0
    for b0 in range(0, n, block):
        rows = sp[window + b0:window + b0 + block]  # [b, 3]
        cand = sp[b0:b0 + block + 2 * window]  # [c, 3]
        d = torch.cdist(rows, cand, compute_mode="donot_use_mm_for_euclid_dist")
        real = (cand[None, :, 0] < 1e12) & (rows[:, None, 0] < 1e12)
        ok = real & (d > 1e-6)
        pairs += int(real.sum()) - min(block, n - b0)
        d = torch.where(ok, d, torch.inf)
        near = torch.topk(d, k, dim=1, largest=False).values
        found = torch.isfinite(near)
        cnt = found.sum(1)
        vals = torch.where(found, near, 0.0)
        fill = (k - cnt) * vals.amax(1)
        m = min(block, n - b0)
        md[b0:b0 + m] = ((vals.sum(1) + fill) / k)[:m]
    out = torch.empty_like(md)
    out[order] = md
    return out.cpu().numpy(), pairs


def keep_rows(host: dict, flags: dict, device) -> dict:
    """The chain on ``host``'s rows: ``kept`` (the rows kept, in order),
    ``sor_ids`` (the rows that entered SOR), their exact mean distances
    ``md``, SOR's threshold ``thr``, and ``sor_pairs`` (the candidate pairs
    of SOR's windows) and ``sor_points``."""
    idx = np.arange(host["pos"].shape[0])
    idx = idx[bbox_mask(host["pos"][idx], flags["bbox"])]
    idx = idx[alpha_mask(host["opacity"][idx], flags["min_opacity"])]
    idx = idx[density_mask(host["pos"][idx], flags["density_sensitivity"])]
    k, sigma, window = sor_settings(flags["sor_intensity"])
    md, pairs = sor_mean_dists(host["pos"][idx], k, window, device)
    thr = md.mean() + sigma * md.std()
    return {"kept": idx[md < thr], "sor_ids": idx, "md": md, "thr": thr,
            "sor_pairs": pairs, "sor_points": len(idx)}


def left_out(info: dict, band: float) -> set:
    """The rows whose exact mean distance lies within ``band`` of SOR's
    threshold (relative to it): the port's approximate distances may put
    them on either side, so either outcome stands."""
    near = np.abs(info["md"] - info["thr"]) <= band * info["thr"]
    return set(info["sor_ids"][near].tolist())


def _kept_set(ids, info, band) -> tuple[int, np.ndarray]:
    """(rows wrong in the kept set: matching no row, repeating one, or
    missing or extra outside the band; the mask of ``ids`` that matched)"""
    hit = ids >= 0
    got = ids[hit].tolist()
    bad = int((~hit).sum()) + (len(got) - len(set(got)))
    skip = left_out(info, band)
    kept = set(info["kept"].tolist())
    bad += len((set(got) - kept) - skip) + len((kept - set(got)) - skip)
    return bad, hit


def _lookup(row_keys, rows, keys) -> np.ndarray:
    """The row of each of ``keys`` among ``rows`` (keyed by ``row_keys``),
    -1 where none has it."""
    table = dict(zip(row_keys, rows.tolist()))
    return np.asarray([table.get(k, -1) for k in keys], np.int64)


def splat_fields(host: dict, rows):
    """The .splat records of ``rows`` and their sort metric."""
    ls, op = host["log_scale"][rows], host["opacity"][rows]
    alpha = (1.0 / (1.0 + np.exp(-op))).astype(np.float32)
    out = np.zeros(len(rows), SPLAT)
    out["pos"] = host["pos"][rows]
    out["scale"] = np.exp(ls)
    rgb = np.clip((0.5 + SH_C0 * host["sh_dc"][rows]) * 255.0, 0, 255).astype(np.uint8)
    out["color"] = np.concatenate([rgb, np.clip(alpha * 255.0, 0, 255).astype(np.uint8)[:, None]],
                                  axis=1)
    q = host["quat"][rows]
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    out["rot"] = np.clip(q * 128.0 + 128.0, 0, 255).astype(np.uint8)
    return out, np.exp(ls.sum(1)) * alpha


def splat_file(host: dict, rows) -> np.ndarray:
    """The .splat file of ``rows``: records by descending metric."""
    out, metric = splat_fields(host, rows)
    return out[np.argsort(-metric, kind="stable")]


def _pos_keys(pos) -> list:
    return np.ascontiguousarray(pos, np.float32).view("V12").ravel().tolist()


def compare_splat(got: np.ndarray, host: dict, info: dict, band: float) -> int:
    """Records of a .splat file the reference does not bear out: those
    matching no row that entered SOR or repeating one, kept rows missing
    and extra rows (outside the band), records with a scale more than one
    float32 ulp or a byte more than one unit from the row's, and
    neighbours out of descending-metric order."""
    cand = info["sor_ids"]
    ids = _lookup(_pos_keys(host["pos"][cand]), cand, _pos_keys(got["pos"]))
    bad, hit = _kept_set(ids, info, band)
    want, metric = splat_fields(host, ids[hit])
    g = got[hit]
    ulp = np.spacing(np.abs(want["scale"])).astype(np.float64)
    off = (np.abs(g["scale"].astype(np.float64) - want["scale"]) > ulp).any(1)
    for key in ("color", "rot"):
        off |= (np.abs(g[key].astype(int) - want[key].astype(int)) > 1).any(1)
    return bad + int(off.sum()) + int((metric[1:] > metric[:-1]).sum())


SPZ_MAGIC = 0x5053474E
SPZ_COLOR_SCALE = 0.15
SPZ_ROT_STEP = np.sqrt(0.5) / 511.0  # a stored rotation component's step
DIM_FOR_DEGREE = {0: 0, 1: 3, 2: 8, 3: 15}


def read_spz(path) -> dict:
    """A version-3 .spz file (gzip around a 16-byte header and planar
    sections) decoded to its stored integers and values."""
    import gzip
    import struct

    with open(path, "rb") as f:
        body = gzip.decompress(f.read())
    magic, version, n, sh_deg, frac, _, _ = struct.unpack("<IIIBBBB", body[:16])
    if magic != SPZ_MAGIC or version != 3:
        raise ValueError(f"not a version-3 .spz file: magic {magic:#x}, version {version}")
    at = 16

    def take(count, dtype=np.uint8):
        nonlocal at
        out = np.frombuffer(body, dtype, count, at)
        at += count * np.dtype(dtype).itemsize
        return out

    b = take(n * 9).reshape(n, 3, 3).astype(np.int32)
    q = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    q = np.where(q >= 1 << 23, q - (1 << 24), q)
    out = {"n": n, "sh_degree": sh_deg, "pos_q": q, "pos_step": 1.0 / (1 << frac),
           "alpha": take(n), "color": take(n * 3).reshape(n, 3),
           "scale": take(n * 3).reshape(n, 3)}
    rot = take(n, np.dtype("<u4")).astype(np.int64)
    big = rot >> 30
    step = SPZ_ROT_STEP
    quat = np.zeros((n, 4))  # x, y, z, w as stored
    slot = np.zeros(n, np.int64)
    for i in range(4):
        stored = big != i
        word = (rot >> ((2 - slot) * 10)) & 0x3FF
        val = (word & 0x1FF) * step * np.where(word >> 9, -1.0, 1.0)
        quat[:, i] = np.where(stored, val, 0.0)
        slot += stored
    rest = (quat ** 2).sum(1)
    quat[np.arange(n), big] = np.sqrt(np.maximum(0.0, 1.0 - rest))
    out["quat"] = quat[:, [3, 0, 1, 2]]  # wxyz
    out["rot_step"] = step
    dim = DIM_FOR_DEGREE[sh_deg]
    out["sh"] = take(n * dim * 3).reshape(n, dim, 3)
    return out



def spz_fields(host: dict, rows) -> dict:
    """Each stored field of ``rows`` before quantization, in the units of
    its byte (positions in fixed-point steps), the rotation as the unit
    quaternion whose largest (x, y, z, w) component is positive."""
    op = np.clip(host["opacity"][rows].astype(np.float64), -20.0, 20.0)
    q = host["quat"][rows].astype(np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    big = np.argmax(np.abs(q[:, [1, 2, 3, 0]]), axis=1)
    sign = np.where(np.take_along_axis(q[:, [1, 2, 3, 0]], big[:, None], 1) < 0, -1.0, 1.0)
    return {"pos": host["pos"][rows].astype(np.float64) * 4096.0,
            "alpha": 255.0 / (1.0 + np.exp(-op)),
            "color": np.clip((host["sh_dc"][rows] * SPZ_COLOR_SCALE + 0.5) * 255.0, 0, 255),
            "scale": np.clip((host["log_scale"][rows] + 10.0) * 16.0, 0, 255),
            "quat": q * sign,
            "sh": host["sh_rest"][rows].transpose(0, 2, 1)}


def spz_store(host: dict, rows, sh_degree: int) -> dict:
    """``rows`` as ``read_spz`` returns a file that stores them, rotations
    and SH unsnapped."""
    w = spz_fields(host, rows)
    dim = DIM_FOR_DEGREE[sh_degree]
    return {"n": len(rows), "pos_q": np.round(w["pos"]).astype(np.int64),
            "alpha": w["alpha"].astype(np.uint8), "color": w["color"].astype(np.uint8),
            "scale": w["scale"].astype(np.uint8), "quat": w["quat"],
            "rot_step": SPZ_ROT_STEP, "sh": np.round(w["sh"][:, :dim] * 128.0 + 128.0)}


# a stored field's widest gap from its value, in its steps: a rounded
# position half a step; a truncated byte one step, and one more where a
# device's sigmoid or exp lies an ulp across a step; a rotation's largest
# component, rebuilt from the other three (each within half a step), 1.5
# steps; SH half a snapping step and half a unit
SPZ_TOLERANCE = {"pos": 0.5 + 1e-6, "alpha": 2.0, "color": 2.0, "scale": 2.0, "quat": 2.0,
                 "sh": 1.0}


def compare_spz(got: dict, host: dict, info: dict, band: float) -> int:
    """Rows of a decoded .spz file the reference does not bear out: rows
    matching no row that entered SOR (by stored position) or repeating
    one, kept rows missing and extra rows (outside the band), fields beyond
    ``SPZ_TOLERANCE``, and rows out of their source order."""
    cand = info["sor_ids"]
    pos_q = np.round(host["pos"][cand].astype(np.float64) * 4096.0).astype(np.int64)
    ids = _lookup([r.tobytes() for r in pos_q], cand,
                  [r.tobytes() for r in np.asarray(got["pos_q"], np.int64)])
    bad, hit = _kept_set(ids, info, band)
    want = spz_fields(host, ids[hit])
    gap = {"pos": np.abs(got["pos_q"][hit] - want["pos"]).max(1)}
    for key in ("alpha", "color", "scale"):
        g = got[key][hit].astype(np.float64)
        gap[key] = np.abs(g - want[key]).reshape(len(g), -1).max(1)
    rq, wq = got["quat"][hit], want["quat"]
    # q and -q are one rotation: a near tie for the largest component may
    # store either
    gap["quat"] = np.minimum(np.abs(rq - wq).max(1), np.abs(rq + wq).max(1)) / got["rot_step"]
    dim = got["sh"].shape[1]
    if dim:
        sh = (got["sh"][hit].astype(np.float64) - 128.0) / 128.0
        snap = np.where(np.arange(dim)[None, :, None] < 3, 8.0, 16.0) / 128.0
        gap["sh"] = (np.abs(sh - want["sh"][:, :dim]) / snap).reshape(len(sh), -1).max(1)
    off = np.zeros(int(hit.sum()), bool)
    for key, g in gap.items():
        off |= g > SPZ_TOLERANCE[key]
    return bad + int(off.sum()) + int((np.diff(ids[hit]) <= 0).sum())

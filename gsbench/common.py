"""Helpers the traffic loops share: the port's objects built from a
configuration, reservoir samples of a window's outputs, and the numbers
that decide ``correct``."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gsbench.reference import render as ref_render


# K5's and K6's FP32 instructions for each (candidate, pixel) pair that
# composites (the port's own count, chip_smoke.py): forming the pair's
# alpha and the block product takes 15, a contributing pair 5 more in K5
# and 50 more in K6 (its weight, the gradient terms and their sums).
K5_PAIR_OPS, K6_PAIR_OPS = 20, 65
# bytes of a composited candidate row (K5: mean, conic, color and alpha;
# K6 also writes their gradients) and of a pixel (rgb in or out, and T)
K5_ROW_BYTES, K6_ROW_BYTES, PIXEL_BYTES = 36, 72, 16


# SOR's FP32 instructions for each (point, candidate) pair of its window:
# the distance (3 subtractions, 3 multiply-adds, the square root), its
# validity compare, and a compare and an add to select and sum the k
# nearest; the positions are read once and the means written once
K1_PAIR_OPS, K1_POINT_BYTES = 10, 16


def sor_work(counts: dict, times: int) -> dict:
    """K1's needed operations and bytes for ``times`` conversions
    (``counts``: the reference's ``keep_rows``)."""
    return {"k1": {"ops": counts["sor_pairs"] * K1_PAIR_OPS * times,
                   "bytes": counts["sor_points"] * K1_POINT_BYTES * times}}


def frame_work(work: dict, pixels: int) -> dict:
    """K5's and K6's needed operations and bytes for one frame."""
    return {"k5": {"ops": work["pairs"] * K5_PAIR_OPS,
                   "bytes": work["rows"] * K5_ROW_BYTES + pixels * PIXEL_BYTES},
            "k6": {"ops": work["pairs"] * K6_PAIR_OPS,
                   "bytes": work["rows"] * K6_ROW_BYTES + pixels * PIXEL_BYTES}}


class Phases:
    """Seconds each phase of a set-up took, for standard error."""

    def __init__(self):
        self.t = time.perf_counter()
        self.log: list = []

    def mark(self, name: str):
        now = time.perf_counter()
        self.log.append((name, round(now - self.t, 4)))
        self.t = now


def checks_from(numbers: dict, limits: dict) -> list[dict]:
    """Each compared number beside its limit (the cell's limits file)."""
    return [{"name": k, "value": float(v), "limit": float(limits[k])}
            for k, v in numbers.items()]


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(seed)
        self.items: list = []
        self.seen = 0

    def slot(self):
        """The slot the next item takes, or None where it is not kept."""
        i = self.seen
        self.seen += 1
        if i < self.size:
            self.items.append(None)
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.size else None


def orbit_eye(cam_cfg: dict, azimuth_deg: float) -> list:
    """The configuration's eye turned by ``azimuth_deg`` about the vertical
    through its target."""
    eye = np.asarray(cam_cfg["eye"], np.float64)
    tgt = np.asarray(cam_cfg["target"], np.float64)
    a = math.radians(azimuth_deg)
    d = eye - tgt
    d = np.array([d[0] * math.cos(a) + d[2] * math.sin(a), d[1],
                  -d[0] * math.sin(a) + d[2] * math.cos(a)])
    return (tgt + d).tolist()


def cameras(cam_cfg: dict, azimuths, device):
    """(the port's cameras, the reference's cameras), one per azimuth."""
    from gsconverter_tpu_torch.render.camera import Camera

    prog, ref = [], []
    for az in azimuths:
        eye = orbit_eye(cam_cfg, az)
        args = (eye, cam_cfg["target"], cam_cfg["up"], cam_cfg["fov_deg"], cam_cfg["width"],
                cam_cfg["height"])
        prog.append(Camera.look_at(*args, device=device))
        ref.append(ref_render.Camera(*args, device=device))
    return prog, ref


def program_cloud(p: dict, sh_degree: int):
    """The port's tensor cloud of a minted scene's tensors."""
    from gsconverter_tpu_torch.cloud import SplatCloud

    return SplatCloud(pos=p["pos"], sh_dc=p["sh_dc"], sh_rest=p["sh_rest"],
                      opacity=p["opacity"], log_scale=p["log_scale"], quat=p["quat"],
                      normal=torch.zeros_like(p["pos"]), active_sh_degree=sh_degree)


def program_budget(cloud, cam, rcfg: dict):
    """The port's ``auto_budget`` for ``cloud`` seen by ``cam``, with the
    render keywords it gives, and each tile's budget [T] from its band plan."""
    from gsconverter_tpu_torch.render import rasterizer as rz

    b = rcfg["budget"]
    out = rz.auto_budget(cloud, cam, cap=b["cap"], glob_cap=b["glob_cap"],
                         max_mid=b["max_mid"], band_chunk=rcfg["tile_chunk"])
    kw = dict(binning=rcfg["binning"], max_global=out["max_global"],
              tile_chunk=rcfg["tile_chunk"], block_m=rcfg["block_m"], max_mid=b["max_mid"],
              tile_order=out["tile_order"], band_plan=out["band_plan"])
    n_tiles = (cam.width // ref_render.TILE) * (cam.height // ref_render.TILE)
    per_tile = np.zeros(n_tiles, np.int64)
    order, at = np.asarray(out["tile_order"], np.int64), 0
    n = cloud.pos.shape[0]
    for chunks, mb in out["band_plan"]:
        ids = order[at:at + chunks * rcfg["tile_chunk"]]
        per_tile[ids[ids < n_tiles]] = min(int(mb), n)
        at += chunks * rcfg["tile_chunk"]
    return kw, per_tile, int(out["max_global"])


def budget_diff(prog_tiles, prog_glob, ref_tiles, ref_glob) -> int:
    """Tiles whose budget differs, plus every tile where the global count
    joining them does."""
    diff = int((np.asarray(prog_tiles) != np.asarray(ref_tiles)).sum())
    return diff + (len(ref_tiles) if prog_glob != ref_glob else 0)


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.detach().double())) for k, v in d.items()}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of | ||prog|| - ||ref|| | against the larger of the
    reference leaf's norm and the median leaf's (of ``keep``'s leaves)."""
    keys = [k for k in ref if keep is None or k in keep]
    pn, rn = _norms({k: prog[k] for k in keys}), _norms({k: ref[k] for k in keys})
    med = float(np.median([rn[k] for k in keys]))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def moved_leaves(ref_grads: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding: a norm
    at least a thousandth of the median leaf's."""
    rn = _norms(ref_grads)
    med = float(np.median(list(rn.values())))
    return {k for k, v in rn.items() if v >= 1e-3 * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training step's compared numbers: each checked step's loss, the
    first gradient and the parameters' change, by the worst leaf."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    keep = moved_leaves(ref["first"])
    change_p = {k: prog["after"][k] - prog["start"][k] for k in prog["after"]}
    change_r = {k: ref["after"][k] - ref["start"][k] for k in ref["after"]}
    return {"loss_rel": loss,
            "grad_norm_gap": worst_leaf_gap(prog["first"], ref["first"]),
            "change_norm_gap": worst_leaf_gap(change_p, change_r, keep)}


def bf16(host: dict) -> dict:
    """A host scene's arrays rounded to bfloat16 (the control's inputs)."""
    return {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy() for k, v in host.items()}

"""Scenes minted from the seed, the same on both sides of the comparison.

Each scene is made where the run works, by a ``torch.Generator`` seeded
with the run's seed, in one large draw of normal variates whose columns
are scaled to the configuration's distributions.  ``write_ply`` writes a
scene as a binary 3DGS PLY with the benchmark's own code, for the cells
whose program reads a file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

SH_REST_COEFFS = 15  # per channel, the 3DGS layout's [N, 3, 15]
DIM_FOR_DEGREE = {0: 0, 1: 3, 2: 8, 3: 15}


def _normals(seed: int, n: int, cols: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randn(n, cols, generator=g, device=device, dtype=torch.float32)


def mint(scene: dict, seed: int, device) -> dict:
    """A scene of ``scene["splats"]`` splats as float32 tensors on ``device``:
    pos [N,3], sh_dc [N,3], sh_rest [N,3,15] (the degree's coefficients
    drawn, the rest 0), opacity [N] (logit), log_scale [N,3], quat [N,4]
    (wxyz: random unit quaternions or the identity).  The last
    ``flyer_share`` of the rows sit ``flyer_offset`` away on every axis."""
    n = int(scene["splats"])
    dim = DIM_FOR_DEGREE[int(scene["sh_degree"])]
    random_rot = scene["rotation"] == "random"
    cols = 3 + 3 + 3 * dim + 1 + 3 + (4 if random_rot else 0)
    z = _normals(seed, n, cols, device)
    at = 0

    def take(width, mean, sigma):
        nonlocal at
        out = z[:, at:at + width] * sigma + mean
        at += width
        return out

    pos = take(3, 0.0, scene["pos_sigma"])
    nf = int(n * scene.get("flyer_share", 0.0))
    if nf:
        pos[n - nf:] += scene["flyer_offset"]
    sh_dc = take(3, 0.0, scene["sh_dc_sigma"])
    sh_rest = torch.zeros(n, 3, SH_REST_COEFFS, dtype=torch.float32, device=device)
    if dim:
        sh_rest[:, :, :dim] = take(3 * dim, 0.0, scene["sh_rest_sigma"]).view(n, 3, dim)
    opacity = take(1, scene["opacity_mean"], scene["opacity_sigma"])[:, 0]
    log_scale = take(3, scene["log_scale_mean"], scene["log_scale_sigma"])
    if random_rot:
        quat = take(4, 0.0, 1.0)
        quat = quat / torch.linalg.norm(quat, dim=1, keepdim=True)
    else:
        quat = torch.zeros(n, 4, dtype=torch.float32, device=device)
        quat[:, 0] = 1.0
    return {k: v.contiguous() for k, v in dict(
        pos=pos, sh_dc=sh_dc, sh_rest=sh_rest, opacity=opacity, log_scale=log_scale,
        quat=quat).items()}


def to_host(scene: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in scene.items()}


def ply_fields(n_rest: int = 45) -> list[str]:
    return (["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
            + [f"f_rest_{i}" for i in range(n_rest)]
            + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"])


def write_ply(path, host: dict) -> None:
    """A binary little-endian 3DGS PLY of a host scene (``to_host``), every
    SH coefficient as its own ``f_rest`` column, channel-major, synced to
    the disk."""
    n = host["pos"].shape[0]
    names = ply_fields()
    cols = np.zeros((n, len(names)), np.float32)
    cols[:, 0:3] = host["pos"]
    cols[:, 6:9] = host["sh_dc"]
    cols[:, 9:54] = host["sh_rest"].reshape(n, 45)
    cols[:, 54] = host["opacity"]
    cols[:, 55:58] = host["log_scale"]
    cols[:, 58:62] = host["quat"]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(cols.tobytes())
        # on the disk before the window opens: its write-back would
        # otherwise run during the measured conversions
        f.flush()
        os.fsync(f.fileno())

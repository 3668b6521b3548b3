"""Checkpoint / resume of the canonical cloud between filter stages.

A preempted conversion resumes at its last completed stage.  The file
format is the JAX package's, so a snapshot written by either package loads
in the other: one directory a stage holding ``shard{i}.npz`` (the leaves,
``extra__<name>`` for each extra) and ``manifest.json`` (``stage``, ``n``,
``active_sh_degree``, ``shards``).  Under a mesh of more than one rank
every rank holds the whole cloud, and rank r writes shard r: its
``shard_bounds(n, r, size)`` rows; rank 0 writes the manifest once every
shard is on disk.  ``load`` concatenates the shards in order.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..cloud import SplatCloud
from ..parallel.mesh import multi_rank_mesh

MANIFEST = "manifest.json"


def _rank_and_size() -> tuple[int, int]:
    mesh = multi_rank_mesh()
    return (0, 1) if mesh is None else (mesh.rank, mesh.size)


def _barrier() -> None:
    mesh = multi_rank_mesh()
    if mesh is not None:
        mesh.barrier()


def save(cloud: SplatCloud, directory: str, stage: str) -> str:
    """Snapshot the cloud after ``stage``; returns the snapshot directory."""
    snap = os.path.join(directory, stage)
    os.makedirs(snap, exist_ok=True)
    c = cloud.to_numpy()
    arrays = dict(
        pos=c.pos, sh_dc=c.sh_dc, sh_rest=c.sh_rest, opacity=c.opacity,
        log_scale=c.log_scale, quat=c.quat, normal=c.normal,
    )
    if c.rgb is not None:
        arrays["rgb"] = c.rgb
    for k, v in c.extras.items():
        arrays[f"extra__{k}"] = v
    shard, shards = _rank_and_size()
    if shards > 1:
        from ..parallel.io import shard_bounds

        lo, hi = shard_bounds(cloud.n, shard, shards)
        arrays = {k: v[lo:hi] for k, v in arrays.items()}
    np.savez_compressed(os.path.join(snap, f"shard{shard}.npz"), **arrays)
    _barrier()  # every shard on disk before the manifest names them
    if shard == 0:
        with open(os.path.join(snap, MANIFEST), "w") as f:
            json.dump(dict(stage=stage, n=cloud.n,
                           active_sh_degree=cloud.active_sh_degree,
                           shards=shards), f)
    _barrier()
    return snap


def load(directory: str, stage: str) -> SplatCloud:
    """The host cloud snapshotted after ``stage`` (numpy leaves)."""
    snap = os.path.join(directory, stage)
    with open(os.path.join(snap, MANIFEST)) as f:
        manifest = json.load(f)
    parts = []
    for s in range(manifest["shards"]):
        with np.load(os.path.join(snap, f"shard{s}.npz")) as z:
            parts.append({k: z[k] for k in z.files})
    merged = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    extras = {k[len("extra__"):]: v for k, v in merged.items()
              if k.startswith("extra__")}
    return SplatCloud(
        pos=merged["pos"], sh_dc=merged["sh_dc"], sh_rest=merged["sh_rest"],
        opacity=merged["opacity"], log_scale=merged["log_scale"],
        quat=merged["quat"], normal=merged["normal"], rgb=merged.get("rgb"),
        extras=extras, active_sh_degree=manifest["active_sh_degree"],
    )


def latest_stage(directory: str, stages: list[str]) -> str | None:
    """The last stage (in pipeline order) with a complete snapshot."""
    done = None
    for s in stages:
        if os.path.exists(os.path.join(directory, s, MANIFEST)):
            done = s
    return done

"""Sharded file IO.

Binary PLY vertex elements are fixed-size records, so each rank seeks to
its slice and reads only its shard, and a strided write lets each rank
write only its own record range.  Other formats gather to rank 0, which
writes.
"""

from __future__ import annotations

import os

import numpy as np
import torch.distributed as dist

from ..cloud import SplatCloud
from ..formats.ply_gs import cloud_from_vertex_array, vertex_array_from_cloud
from ..utils import ply as ply_io
from .mesh import Mesh, active_mesh


def shard_bounds(n: int, shard: int, num_shards: int) -> tuple[int, int]:
    """Contiguous row range [start, end) for a shard (balanced split)."""
    base = n // num_shards
    rem = n % num_shards
    start = shard * base + min(shard, rem)
    end = start + base + (1 if shard < rem else 0)
    return start, end


def read_ply_sharded(path: str, shard: int, num_shards: int) -> SplatCloud:
    """Read only this shard's slice of a binary PLY's vertex element (a host
    cloud).  Seeks directly to the shard's byte range."""
    with open(path, "rb") as f:
        specs, fmt, _ = ply_io.read_header(f)
        if fmt != "binary_little_endian":
            raise ValueError("sharded read requires binary_little_endian PLY")
        offset = f.tell()
        for name, count, props in specs:
            if any(kind[0] == "list" for _, kind in props):
                raise ValueError("sharded read does not support list properties")
            dt = np.dtype([(p, "<" + ply_io._PLY_TO_NP[k[1]]) for p, k in props])
            if name == "vertex":
                start, end = shard_bounds(count, shard, num_shards)
                f.seek(offset + start * dt.itemsize)
                raw = f.read((end - start) * dt.itemsize)
                return cloud_from_vertex_array(np.frombuffer(raw, dtype=dt).copy())
            offset += dt.itemsize * count
    raise ValueError("PLY file does not contain 'vertex' element")


def _ply_header_bytes(dtype: np.dtype, total_n: int,
                      comments: tuple[str, ...] = ()) -> bytes:
    """Deterministic binary-little-endian PLY header for a vertex dtype:
    every rank must produce the same bytes from (dtype, total_n), since the
    strided write places records after it.  ``utils.ply``'s header layout."""
    lines = ["ply", "format binary_little_endian 1.0"]
    lines += [f"comment {c}" for c in comments]
    lines.append(f"element vertex {total_n}")
    for name in dtype.names:
        lines.append(f"property {ply_io._np_type_name(dtype[name])} {name}")
    lines.append("end_header")
    return ("\n".join(lines) + "\n").encode("ascii")


def write_ply_strided(cloud: SplatCloud, path: str, shard: int,
                      num_shards: int, total_n: int,
                      prefix_nonspatial: bool = False) -> None:
    """Each rank seek-writes ONLY its shard's record range of one 3DGS PLY.

    Shard k owns rows ``shard_bounds(total_n, k, num_shards)`` and writes
    them at ``header_len + start * itemsize``; shard 0 also writes the
    header.  The shard's row count must match its bounds.  SH crop is off
    (the record layout must be the same on every rank).

    Every rank opens the path with ``O_CREAT`` and without ``O_TRUNC`` (no
    existence check to race on) and sets the file's size to the final one,
    so a longer stale file at the path ends at the right size; ranks touch
    only their own byte ranges.  (The JAX package opens an existing file
    "r+b" after an existence check, which races between ranks and leaves a
    longer stale file's trailing bytes.)
    """
    arr = vertex_array_from_cloud(cloud, crop_sh=False,
                                  prefix_nonspatial=prefix_nonspatial)
    start, end = shard_bounds(total_n, shard, num_shards)
    if end - start != len(arr):
        raise ValueError(
            f"shard {shard}/{num_shards} holds {len(arr)} rows, bounds say "
            f"{end - start}")
    header = _ply_header_bytes(arr.dtype, total_n)
    fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
    with os.fdopen(fd, "r+b") as f:
        os.ftruncate(fd, len(header) + total_n * arr.dtype.itemsize)
        if shard == 0:
            f.write(header)
        f.seek(len(header) + start * arr.dtype.itemsize)
        f.write(arr.tobytes())


def gather_and_write(cloud: SplatCloud, path: str, writer, mesh: Mesh | None = None,
                     **kwargs) -> None:
    """Write the cloud whose rows are spread over the ranks, each rank
    passing its own rows (``mesh`` defaults to the active mesh).

    One rank writes directly.  A ``.ply`` with no writer options whose
    per-rank row counts match ``shard_bounds`` takes the strided write
    (only the counts cross the group), then a barrier.  Otherwise every
    leaf is gathered to rank 0, which writes, and the others wait at a
    barrier.
    """
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or mesh.size == 1:
        writer(cloud, path, **kwargs)
        return
    counts = [None] * mesh.size
    dist.all_gather_object(counts, cloud.n, group=mesh.group)
    total_n = int(sum(counts))
    bounds = [shard_bounds(total_n, k, mesh.size) for k in range(mesh.size)]
    if str(path).endswith(".ply") and not kwargs and all(
            hi - lo == c for (lo, hi), c in zip(bounds, counts)):
        write_ply_strided(cloud, path, mesh.rank, mesh.size, total_n)
        mesh.barrier()
        return
    local = cloud.to_numpy()
    parts = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(local._named_leaves(), parts, group=mesh.group, group_dst=0)
    if mesh.rank == 0:
        merged = {name: None if parts[0][name] is None
                  else np.concatenate([p[name] for p in parts])
                  for name in parts[0]}
        writer(local._rebuild(merged), path, **kwargs)
    mesh.barrier()

"""Density filter — voxel histogram + connected-component clustering.

Reference contract (processing/data_processor.py:11-117): voxelize at
floor(coords/voxel_size); count per voxel; keep voxels with
count >= N * threshold%/100; 6-connected BFS over dense voxels -> clusters;
keep the largest cluster (by voxel count, first wins on ties), or every
cluster >= 5% of the largest when ``keep_multicluster``.  Sensitivity slider
s in [0,1] maps to voxel = max(0.1, 2.0 - 1.8 s), threshold = 0.1 + 0.9 s
(data_processor.py:24-28).

The reference's Python BFS is serial; clusters are labelled here by
iterative min-label propagation + pointer jumping over the 6-neighbour
voxel graph, O(log diameter) rounds of vectorized gathers over the table of
occupied voxels.  This module holds the host numpy path, the one a
host-resident cloud takes; the device path over tensors is still to port.

Grid keys are exact 30-bit int32 packs (1024 cells/axis) when the scene
fits; wider scenes pack exact 60-bit int64 keys (1M cells/axis).
"""

from __future__ import annotations

import numpy as np

GRID_BITS = 10
GRID_MAX = (1 << GRID_BITS) - 1
WIDE_BITS = 20


def sensitivity_to_params(sensitivity: float) -> tuple[float, float]:
    voxel = max(0.1, 2.0 - sensitivity * 1.8)
    threshold = 0.1 + sensitivity * 0.9
    return voxel, threshold


def _density_mask_host(
    pos: np.ndarray,
    voxel_size: float,
    threshold_percentage: float,
    keep_multicluster: bool,
) -> np.ndarray:
    """Host-resident numpy path, the one a host cloud takes.

    One key sort + searchsorted adjacency + an O(log diameter) label-
    propagation loop over the table of occupied voxels (typically 30-100x
    smaller than N at the reference's densities); no device transfers.
    """
    n = pos.shape[0]
    vox = np.floor(pos.astype(np.float32, copy=False) / np.float32(voxel_size))
    base = vox.min(axis=0)
    # Key width by extent: scenes within the 1023^3 grid pack exact 30-bit
    # int32 keys (numpy sorts and compares int32 faster than int64); wider
    # scenes take the exact 60-bit int64 pack.
    extent = float((vox.max(axis=0) - base).max()) if n else 0.0
    bits = GRID_BITS if extent <= GRID_MAX else WIDE_BITS
    kdt = np.int32 if bits == GRID_BITS else np.int64
    gmax = (1 << bits) - 1
    vox -= base
    np.clip(vox, 0, gmax, out=vox)
    ci = vox.astype(kdt)
    del vox
    keys = (ci[:, 0] << kdt(2 * bits)) | (ci[:, 1] << kdt(bits)) | ci[:, 2]

    skeys = np.sort(keys)
    is_first = np.empty(n, bool)
    is_first[0] = True
    np.not_equal(skeys[1:], skeys[:-1], out=is_first[1:])
    uniq = skeys[is_first]  # ascending occupied-voxel keys [m]
    starts = np.flatnonzero(is_first)
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    m = uniq.shape[0]

    min_points = int(threshold_percentage / 100.0 * n)
    dense = counts >= min_points  # [m]

    # 6-neighbor adjacency among dense voxels via searchsorted on uniq
    ux, uy, uz = uniq >> kdt(2 * bits), (uniq >> kdt(bits)) & gmax, uniq & gmax
    offs = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        kdt,
    )
    ncoord = np.stack([ux, uy, uz], axis=1)[:, None, :] + offs[None, :, :]
    in_grid = np.all((ncoord >= 0) & (ncoord <= gmax), axis=-1)
    nkeys = ((ncoord[..., 0] << kdt(2 * bits))
             | (ncoord[..., 1] << kdt(bits)) | ncoord[..., 2])
    loc = np.searchsorted(uniq, nkeys.reshape(-1)).reshape(m, 6)
    loc = np.clip(loc, 0, m - 1)
    found = (uniq[loc] == nkeys) & in_grid
    neigh_ok = found & dense[loc] & dense[:, None]

    # min-label propagation with pointer jumping (same scheme as stage 2)
    labels = np.where(dense, np.arange(m, dtype=np.int64), m)
    neigh_idx = np.where(neigh_ok, loc, m)  # [m,6]
    while True:
        padded = np.append(labels, m)
        nl = padded[neigh_idx].min(axis=1)
        new = np.where(dense, np.minimum(labels, nl), labels)
        new = np.where(dense, np.minimum(new, padded[new]), new)
        new = np.where(dense, np.minimum(new, padded[padded[new]]), new)
        if np.array_equal(new, labels):
            break
        labels = new

    sizes = np.bincount(np.clip(labels, 0, m - 1), weights=dense, minlength=m)
    if keep_multicluster:
        keep_cluster = sizes >= sizes.max() * 0.05
    else:
        keep_cluster = np.arange(m) == int(np.argmax(sizes))
    vox_keep = dense & keep_cluster[np.clip(labels, 0, m - 1)]

    # Per-point result: a binary search over uniq per point is this path's
    # dominant cost.  When the occupied bounding subgrid is small enough to
    # sit in cache, a direct-index table turns it into one O(N) gather:
    # mixed-radix flat index over (dx, dy, dz) from the voxel coords.
    dx = int(ux.max()) + 1 if m else 1
    dy = int(uy.max()) + 1 if m else 1
    dz = int(uz.max()) + 1 if m else 1
    cells = dx * dy * dz
    if cells <= (1 << 26):  # <= 64 MB bool table
        table = np.zeros(cells, bool)
        table[(ux * dy + uy) * dz + uz] = vox_keep
        flat = (ci[:, 0].astype(np.int64) * dy + ci[:, 1]) * dz + ci[:, 2]
        return table[flat]
    return vox_keep[np.searchsorted(uniq, keys)]


def density_mask(
    pos: np.ndarray,
    voxel_size: float,
    threshold_percentage: float,
    keep_multicluster: bool = False,
) -> np.ndarray:
    """Keep-mask for the density filter over host positions [N,3]."""
    if not isinstance(pos, np.ndarray):
        raise NotImplementedError(
            "density_mask on device tensors is not ported yet (ROADMAP "
            "queue 1, density device path); pass host numpy positions"
        )
    if pos.shape[0] == 0:
        return np.zeros(0, bool)
    return _density_mask_host(
        pos, float(voxel_size), float(threshold_percentage), keep_multicluster
    )

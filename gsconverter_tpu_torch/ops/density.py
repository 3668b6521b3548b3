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
occupied voxels.  Host numpy positions take ``_density_mask_host``; tensor
positions take ``_density_mask_torch`` on their device, the JAX package's
device path: one key sort carrying the unsort payload, one scalar read back
(the occupied-voxel count), segment max/sum into the voxel table, the
searchsorted adjacency and the propagation loop over that table.

Grid keys are exact 30-bit packs (1024 cells/axis) when the scene fits;
wider scenes pack exact 60-bit keys (1M cells/axis).  The host path picks
the width from the floored voxel extent, the device path from the position
extent over the voxel size, as the JAX package's two paths do.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _density_mask_torch(
    pos: torch.Tensor,
    voxel_size: float,
    threshold_percentage: float,
    keep_multicluster: bool,
) -> torch.Tensor:
    """Tensor path on ``pos``'s device (JAX ``_density_stage1/2`` and
    ``_density_gather``).  Keys are int64 on both grids (torch has no ``<<``
    on uint32 on the CPU); the sort order and every key compare are those
    of the JAX package's int32 / int64 keys.  ``min_points`` is formed in
    f32, as the JAX device path forms it (the host path uses ``int()`` of an
    f64 product; the two differ where the product lies within an f32 ulp of
    an integer)."""
    n = pos.shape[0]
    dev = pos.device
    f32 = torch.float32
    pos = pos.to(f32)
    extent = float((pos.amax(dim=0) - pos.amin(dim=0)).amax())
    bits = GRID_BITS if extent / float(voxel_size) <= GRID_MAX else WIDE_BITS
    gmax = (1 << bits) - 1
    # divide by a device tensor: a CUDA divide by a Python scalar multiplies
    # by its f32 reciprocal, which is not the f32 quotient
    vox = torch.floor(pos / torch.tensor(voxel_size, dtype=f32, device=dev))
    base = vox.amin(dim=0)
    ci = torch.clamp(vox - base, 0, gmax).to(torch.int64)
    del vox
    keys = (ci[:, 0] << (2 * bits)) | (ci[:, 1] << bits) | ci[:, 2]
    del ci

    skeys, order = torch.sort(keys, stable=True)
    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = skeys[1:] != skeys[:-1]
    voxel_id_sorted = torch.cumsum(is_first, 0) - 1
    inv = torch.empty(n, dtype=torch.int64, device=dev)
    inv[order] = voxel_id_sorted
    m = int(voxel_id_sorted[-1]) + 1  # the one scalar read back: n_vox

    # voxel table: unique keys (ascending) and counts by segment max / sum
    uniq = torch.full((m,), -1, dtype=torch.int64, device=dev)
    uniq = uniq.scatter_reduce(0, voxel_id_sorted, skeys, "amax")
    counts = torch.zeros(m, dtype=torch.int64, device=dev).index_add_(
        0, voxel_id_sorted, torch.ones_like(voxel_id_sorted))
    t32 = (np.float32(threshold_percentage) / np.float32(100.0)) * np.float32(n)
    min_points = int(t32.astype(np.int32))
    dense = counts >= min_points

    # 6-neighbour adjacency among dense voxels via searchsorted
    ux, uy, uz = uniq >> (2 * bits), (uniq >> bits) & gmax, uniq & gmax
    offs = torch.tensor(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        dtype=torch.int64, device=dev)
    ncoord = torch.stack([ux, uy, uz], dim=1)[:, None, :] + offs[None, :, :]
    in_grid = ((ncoord >= 0) & (ncoord <= gmax)).all(dim=-1)
    nkeys = ((ncoord[..., 0] << (2 * bits)) | (ncoord[..., 1] << bits)
             | ncoord[..., 2])
    loc = torch.searchsorted(uniq, nkeys.reshape(-1)).reshape(m, 6)
    loc = torch.clamp(loc, 0, m - 1)
    found = (uniq[loc] == nkeys) & in_grid
    neigh_idx = torch.where(dense[loc] & found, loc, m)  # [m, 6]

    # min-label propagation with pointer jumping, until nothing changes
    labels = torch.where(dense, torch.arange(m, device=dev), m)
    sentinel = torch.full((1,), m, dtype=torch.int64, device=dev)
    while True:
        padded = torch.cat([labels, sentinel])
        nl = padded[neigh_idx].amin(dim=1)
        new = torch.where(dense, torch.minimum(labels, nl), labels)
        new = torch.where(dense, torch.minimum(new, padded[new]), new)
        new = torch.where(dense, torch.minimum(new, padded[padded[new]]), new)
        if torch.equal(new, labels):
            break
        labels = new

    # cluster sizes in voxels (the reference counts voxels, not points)
    lab = torch.clamp(labels, 0, m - 1)
    sizes = torch.zeros(m, dtype=torch.int64, device=dev).index_add_(
        0, lab, dense.to(torch.int64))
    if keep_multicluster:
        # f32, as the JAX device path compares
        keep_cluster = sizes.to(f32) >= (sizes.amax().to(f32)
                                         * torch.tensor(0.05, dtype=f32, device=dev))
    else:
        # the single largest cluster; argmax returns the first on ties
        keep_cluster = torch.arange(m, device=dev) == torch.argmax(sizes)
    vox_keep = dense & keep_cluster[lab]
    return vox_keep[inv]


def density_mask(
    pos,
    voxel_size: float,
    threshold_percentage: float,
    keep_multicluster: bool = False,
):
    """Keep-mask for the density filter over positions [N,3]: numpy in,
    numpy out on the host path; a tensor in, a bool tensor on its device
    out on the tensor path."""
    if isinstance(pos, torch.Tensor):
        if pos.shape[0] == 0:
            return torch.zeros(0, dtype=torch.bool, device=pos.device)
        return _density_mask_torch(pos, float(voxel_size),
                                   float(threshold_percentage), keep_multicluster)
    if pos.shape[0] == 0:
        return np.zeros(0, bool)
    return _density_mask_host(
        pos, float(voxel_size), float(threshold_percentage), keep_multicluster
    )

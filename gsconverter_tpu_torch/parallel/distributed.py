"""Multi-device algorithms over the process-group mesh: sharded SOR with a
ring halo exchange, and distributed K-Means.

Every rank holds the full (replicated) input and returns the full result;
it computes only its share of the kernel work, on ``mesh.device``, and
exchanges what the JAX package's ``shard_map`` bodies exchange:

  - **sharded SOR**: every rank performs the single-device path's Morton
    sorts; rank r owns the r-th slab of the sorted order, gets the halo
    rows around it from its ring neighbours, runs the same window route as
    the single-device ``sor_mask`` (kernel K1 on the card) over
    [halo | slab | halo], and the slabs' distances are all-gathered.
  - **chunked K-Means**: the chunks are split over the ranks; each fits
    its own through the batched Lloyd loop (K2 with its K4 sums) and the
    centroids and labels are all-gathered.
  - **distributed K-Means**: every Lloyd step sums locally (K2 + K4), then
    all-reduces the sums and counts; the final labels come from the local
    ``assign`` (K3 on the card) and are all-gathered.

The collectives take device tensors: an NCCL group moves them on the card;
any other group (gloo) carries host tensors, so they are copied to the
host and back.  ``BYTES`` counts what this rank sent through each.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import kmeans as km
from ..ops import sor
from ..ops.padding import PAD_POS, pad_rows, round_up
from .mesh import Mesh

#: bytes this rank sent: ring halos, all-gathers and all-reduces
BYTES = {"halo": 0, "all_gather": 0, "all_reduce": 0}


def _wire(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` as the group's backend carries it."""
    t = t.contiguous()
    return t if mesh.backend == "nccl" else t.cpu()


def _all_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' equal-shaped ``t`` concatenated in rank order (dim 0), on
    ``t``'s device."""
    if mesh.group is None:
        return t
    w = _wire(t, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w, group=mesh.group)
    BYTES["all_gather"] += w.numel() * w.element_size()
    return torch.cat(parts).to(t.device)


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the ranks' ``t``, on ``t``'s device."""
    if mesh.group is None:
        return t
    w = _wire(t, mesh).clone()
    dist.all_reduce(w, group=mesh.group)
    BYTES["all_reduce"] += w.numel() * w.element_size()
    return w.to(t.device)


def _ring_exchange(left_edge: torch.Tensor, right_edge: torch.Tensor,
                   mesh: Mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Send ``left_edge`` to the left neighbour and ``right_edge`` to the
    right one (ring order); returns (the left neighbour's right edge, the
    right neighbour's left edge), on the edges' device."""
    if mesh.group is None or mesh.size == 1:
        return right_edge.clone(), left_edge.clone()
    left = (mesh.rank - 1) % mesh.size
    right = (mesh.rank + 1) % mesh.size
    send_l, send_r = _wire(left_edge, mesh), _wire(right_edge, mesh)
    from_left, from_right = torch.empty_like(send_r), torch.empty_like(send_l)
    ops = [dist.P2POp(dist.isend, send_l, group=mesh.group, group_peer=left, tag=0),
           dist.P2POp(dist.isend, send_r, group=mesh.group, group_peer=right, tag=1),
           dist.P2POp(dist.irecv, from_right, group=mesh.group, group_peer=right, tag=0),
           dist.P2POp(dist.irecv, from_left, group=mesh.group, group_peer=left, tag=1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    BYTES["halo"] += 2 * send_l.numel() * send_l.element_size()
    return from_left.to(left_edge.device), from_right.to(left_edge.device)


# ------------------------------------------------------------- sharded SOR


def sharded_sor_mask(pos: torch.Tensor, mesh: Mesh, k: int = 25, sigma: float = 10.5,
                     passes: int | None = None, window: int | None = None,
                     iters: int | None = None) -> torch.Tensor:
    """Keep-mask over positions [N, 3], computed over the mesh; on
    ``pos``'s device, in the input's order.

    Each pass sorts as the single-device ``sor_mask`` sorts (every rank the
    whole array); rank r takes rows [r * per, (r + 1) * per) of the sorted
    order, ``per`` a multiple of the route's block, with the window's rows
    rounded up to a block (the most a block's candidates reach; at most a
    slab) from each ring neighbour and the sentinel at the ends of the
    ring, as the single-device array ends.  Block boundaries and candidate windows are therefore the
    single-device path's, every point's mean-KNN distance equals it, and
    the mean, sigma and threshold are computed from the gathered distances
    in the single-device order: the mask equals ``sor_mask``'s on every row.
    Any N; settings by sigma as in ``sor_mask``.
    """
    k = min(int(k), sor.MAX_K)
    passes, window, iters = sor.window_settings(sigma, k, passes, window, iters)
    n = pos.shape[0]
    use_kernel, p, block = sor.window_route(n, window)
    per = round_up(n, mesh.size * block) // mesh.size
    halo = min(round_up(window, block), per)
    if halo < window and n > per:
        raise ValueError(f"sharded_sor_mask: window {window} is wider than a slab "
                         f"of {per} rows")
    lo = mesh.rank * per

    def pass_md(spos: torch.Tensor) -> torch.Tensor:
        # the sorted rows padded with sentinels to size * per (pad rows
        # sort last, so the real rows lead both)
        full = pad_rows(spos[:n], per * mesh.size, PAD_POS)
        slab = full[lo:lo + per]
        from_left, from_right = _ring_exchange(slab[:halo], slab[-halo:], mesh)
        if mesh.rank == 0:
            from_left = torch.full_like(from_left, PAD_POS)
        if mesh.rank == mesh.size - 1:
            from_right = torch.full_like(from_right, PAD_POS)
        ext = torch.cat([from_left, slab, from_right]).contiguous()
        md = sor.window_pass_md(ext, k, window, iters, use_kernel, block)
        # a plain-route window wider than 512 may leave per * size < p;
        # those rows are padding, their distances unused
        return pad_rows(_all_gather(md[halo:halo + per], mesh)[:p], p, float("inf"))

    posp = pad_rows(pos.to(mesh.device, torch.float32), p, PAD_POS).contiguous()
    valid = torch.arange(p, device=posp.device) < n
    md = sor._sor_md_window(posp, valid, k, window, passes, iters, use_kernel,
                            block, pass_md=pass_md)
    return sor._sor_mask_stats(md, valid, n, sigma)[:n].to(pos.device)


# -------------------------------------------------------- distributed kmeans

_INIT_POOL_PER_SHARD = 8192


def sharded_kmeans(x: torch.Tensor, k: int, mesh: Mesh, max_iter: int = 10,
                   seed: int = 0, n_valid: int | None = None,
                   precision: str = "bf16"):
    """K-Means over the rows split evenly across the ranks; sums and counts
    all-reduced every Lloyd step.

    The init is de-replicated: each rank contributes a strided subsample
    (<= 8192 of its rows) to an all-gathered pool, and k-means++ runs on
    the pool (from seed's own stream).  ``n_valid``: rows at index >=
    n_valid are padding (at the END, as ``ops.padding.pad_rows`` puts it);
    they stay out of the pool (replaced by its first valid row) and of the
    sums.  The row count must divide by the mesh size.

    Returns (centroids [k, D], labels [N] int32) on ``x``'s device.
    """
    km._check_precision(precision)
    n, d = x.shape
    if n % mesh.size:
        raise ValueError(f"sharded_kmeans: {n} rows do not split over {mesh.size} ranks")
    n_local = n // mesh.size
    grow0 = mesh.rank * n_local
    xb = x[grow0:grow0 + n_local].to(mesh.device, torch.float32).contiguous()
    sub = min(_INIT_POOL_PER_SHARD, n_local)
    stride = max(1, n_local // sub)
    pool = _all_gather(xb[0:sub * stride:stride], mesh)
    nv_local = n_local
    if n_valid is not None:
        # padding is at the global end: each rank's valid rows are a prefix
        nv_local = min(max(int(n_valid) - grow0, 0), n_local)
        rows = torch.arange(0, sub * stride, stride, device=xb.device)
        pvalid = (torch.arange(mesh.size, device=xb.device)[:, None] * n_local
                  + rows).reshape(-1) < int(n_valid)
        first = int(torch.argmax(pvalid.to(torch.uint8)))
        pool = torch.where(pvalid[:, None], pool, pool[first][None, :])
    c = km.init_centroids(pool, int(k), seed)
    for _ in range(int(max_iter)):
        sums, counts, _ = km.lloyd_step(xb, c, int(k), n_valid=nv_local,
                                        precision=precision)
        c = km._centroid_means(_all_reduce(sums, mesh), _all_reduce(counts, mesh), c)
    labels = _all_gather(km.assign(xb, c), mesh)
    return c.to(x.device), labels.to(x.device)


def sharded_kmeans_chunked(x: torch.Tensor, n_valid: int, num_chunks: int,
                           k_per_chunk: int, max_iter: int, seed: int, mesh: Mesh,
                           precision: str = "bf16"):
    """Locality-chunked K-Means (the SOG shN palette) with the chunks split
    over the ranks: chunks are independent fits, each keyed by its global
    index (its init stream and label offset), so the result equals
    ``kmeans_chunked``'s for any mesh size.

    ``x`` is the padded [num_chunks * chunk, D] array (rows at index >=
    n_valid are padding); num_chunks must divide by the mesh size.
    Returns (centroids [num_chunks * k, D], labels [num_chunks * chunk]
    offset by chunk * k), on ``x``'s device.
    """
    km._check_precision(precision)
    if num_chunks % mesh.size:
        raise ValueError(f"sharded_kmeans_chunked: {num_chunks} chunks do not split "
                         f"over {mesh.size} ranks")
    p, d = x.shape
    k = int(k_per_chunk)
    chunk = p // num_chunks
    local = num_chunks // mesh.size
    off = mesh.rank * local
    xc = x[off * chunk:(off + local) * chunk].to(mesh.device, torch.float32)
    xc = xc.reshape(local, chunk, d).contiguous()
    gidx = torch.arange(off, off + local, device=xc.device)
    nv = torch.clamp(int(n_valid) - gidx * chunk, 0, chunk).to(torch.int32)
    valid = torch.arange(chunk, device=xc.device)[None, :] < nv[:, None]
    init = km.init_centroids(xc, k, seed, valid=valid, chunk_offset=off)
    c, labels = km._fit(xc, nv, init, int(max_iter), precision, block_chunks=num_chunks)
    labels = labels + (gidx.to(torch.int32) * k)[:, None]
    cents = _all_gather(c.reshape(local * k, d), mesh)
    return cents.to(x.device), _all_gather(labels.reshape(-1), mesh).to(x.device)

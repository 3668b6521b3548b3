"""Multi-device algorithms over the process-group mesh: sharded SOR with a
ring halo exchange, distributed K-Means, and the depth- and tile-sharded
renders.

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
  - **depth-sharded render**: every rank sorts the whole cloud by depth,
    composites its depth-contiguous chunk (K5 on the card), and the chunks
    fold by the exclusive prefix product of their transmittance (a
    log2(size)-step scan of point-to-point shifts) and a sum over ranks.
  - **tile-sharded render**: rank r owns image rows band r; each rank
    sends every band its first covering splats in depth order by one
    all-to-all, and renders its own band from what it receives.

The collectives take device tensors: an NCCL group moves them on the card;
any other group (gloo) carries host tensors, so they are copied to the
host and back.  ``BYTES`` counts what this rank sent through each.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

import dataclasses

from ..cloud import SH_C0
from ..ops import kmeans as km
from ..ops import sor
from ..ops.padding import PAD_POS, next_pow2, pad_rows, round_up
from ..render import rasterizer as rz
from ..render.project import project_gaussians
from ..utils.log import status_print
from .mesh import Mesh

#: bytes this rank sent: ring halos, all-gathers, all-reduces, the render's
#: transmittance scan (``_shift``) and its all-to-all
BYTES = {"halo": 0, "all_gather": 0, "all_reduce": 0, "scan": 0, "all_to_all": 0}


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


def _shift(t: torch.Tensor, s: int, mesh: Mesh) -> torch.Tensor:
    """Send ``t`` to rank (r + s) % size; returns what rank (r - s) % size
    sent, on ``t``'s device (``t`` itself where that is this rank)."""
    if mesh.group is None or s % mesh.size == 0:
        return t
    w = _wire(t, mesh)
    got = torch.empty_like(w)
    # one send and one receive, posted in this order on every rank: NCCL
    # ignores tags and matches a pair's operations by their order
    ops = [dist.P2POp(dist.isend, w, group=mesh.group, group_peer=(mesh.rank + s) % mesh.size),
           dist.P2POp(dist.irecv, got, group=mesh.group,
                      group_peer=(mesh.rank - s) % mesh.size)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    BYTES["scan"] += w.numel() * w.element_size()
    return got.to(t.device)


def _all_to_all(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` [size, ...]: row j goes to rank j; row i of the result is what
    rank i sent this rank.  On ``t``'s device."""
    if t.shape[0] != mesh.size:
        raise ValueError(f"_all_to_all takes [{mesh.size}, ...], got {list(t.shape)}")
    if mesh.group is None or mesh.size == 1:
        return t
    w = _wire(t, mesh)
    got = torch.empty_like(w)
    dist.all_to_all_single(got, w, group=mesh.group)
    BYTES["all_to_all"] += w.numel() * w.element_size()
    return got.to(t.device)


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


# ----------------------------------------------------------- sharded render

#: a render leaf's columns in the tile-sharded render's feature rows
_RENDER_LEAVES = ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat")


def _render_rows(cloud, dev: torch.device, idx=None):
    """The cloud's render leaves (rows ``idx``, default all) as float32
    tensors on ``dev``, with no other leaf."""
    cl = rz._leaves_on(cloud, dev)
    take = (lambda a: a) if idx is None else (lambda a: a[idx])
    return cl.replace(**{k: take(getattr(cl, k)) for k in _RENDER_LEAVES},
                      normal=None, rgb=None, extras={})


def _per_rank(n: int, mesh: Mesh, name: str) -> int:
    if n % mesh.size:
        raise ValueError(f"{name}: {n} splats do not split over {mesh.size} ranks; "
                         "pad the cloud first (sharding.pad_cloud)")
    return n // mesh.size


def _depth_order(cl, cam) -> torch.Tensor:
    """The stable front-to-back order of every splat, those behind the
    camera last (JAX's stable ``argsort``)."""
    proj = project_gaussians(cl.pos, cl.log_scale, cl.quat, cam)
    return torch.argsort(torch.where(proj["in_front"], proj["depth"], torch.inf), stable=True)


def sharded_render(cloud, cam, mesh: Mesh, **kw) -> torch.Tensor:
    """The [H, W, 3] image of ``cloud``, rendered over the mesh by depth.

    Every rank sorts the whole cloud by depth and takes the rank-th of
    ``size`` equal chunks of the sorted splats; it renders its chunk
    against black (``render(**kw)``, K5 on the card), and again as white
    splats of SH degree 0 for the chunk's transmittance.  The exclusive
    prefix product of the ranks' transmittance (a Hillis-Steele scan of
    ``_shift``s of one [H, W, 1] plane, then a shift by one) weighs each
    chunk's image, and an all-reduce sums them: every rank returns the same
    image, on ``mesh.device``.  The cloud's N must divide by the mesh size
    (``sharding.pad_cloud``).
    """
    dev = mesh.device
    cl = _render_rows(cloud, dev)
    per = _per_rank(cl.pos.shape[0], mesh, "sharded_render")
    cam = cam.to(dev)
    order = _depth_order(cl, cam)
    chunk = _render_rows(cl, dev, order[mesh.rank * per:(mesh.rank + 1) * per])
    black = torch.zeros(3, device=dev)
    rgb = rz.render(chunk, cam, bg=black, **kw)
    white = chunk.replace(sh_dc=torch.full_like(chunk.sh_dc, (1.0 - 0.5) / SH_C0),
                          sh_rest=torch.zeros_like(chunk.sh_rest))
    acc = rz.render(white, cam, bg=black, sh_degree=0, **kw)
    trans = 1.0 - torch.clamp(acc[..., :1], 0.0, 1.0)
    v, s = trans, 1
    while s < mesh.size:
        prev = _shift(v, s, mesh)
        if mesh.rank >= s:
            v = prev * v
        s *= 2
    prev = _shift(v, 1, mesh)
    prefix = torch.ones_like(trans) if mesh.rank == 0 else prev
    return _all_reduce(prefix * rgb, mesh)


def _band_covers(proj, h: int, rows_per: int, n_bands: int) -> torch.Tensor:
    """[N, n_bands] bool: splat i in front of the camera covers a row of
    band j (its clipped y +- radius, floor-divided into bands)."""
    y, r = proj["means2d"][:, 1], proj["radius"]
    d0 = torch.div(torch.clamp(y - r, 0, h - 1), rows_per, rounding_mode="floor")
    d1 = torch.div(torch.clamp(y + r, 0, h - 1), rows_per, rounding_mode="floor")
    d0, d1 = d0.to(torch.int32), d1.to(torch.int32)
    bands = torch.arange(n_bands, dtype=torch.int32, device=y.device)
    return ((d0[:, None] <= bands[None, :]) & (d1[:, None] >= bands[None, :])
            & proj["in_front"][:, None])


def band_occupancy(cloud, cam, mesh: Mesh) -> torch.Tensor:
    """[size, size] int32, on ``mesh.device``: row i, column j counts rank
    i's splats (the i-th of ``size`` equal row ranges of ``cloud``) that
    cover image row band j.  The demand that ``sharded_render_tiles``'s
    per-band budget must meet.  N must divide by the mesh size."""
    dev = mesh.device
    per = _per_rank(cloud.n, mesh, "band_occupancy")
    mine = _render_rows(cloud, dev, slice(mesh.rank * per, (mesh.rank + 1) * per))
    cam = cam.to(dev)
    proj = project_gaussians(mine.pos, mine.log_scale, mine.quat, cam)
    covers = _band_covers(proj, cam.height, cam.height // mesh.size, mesh.size)
    return _all_gather(covers.sum(0, dtype=torch.int32)[None, :], mesh)


def sharded_render_tiles(cloud, cam, mesh: Mesh, budget: int | None = None,
                         **kw) -> torch.Tensor:
    """The [H, W, 3] image of ``cloud``, rendered over the mesh by image
    row bands: rank r renders rows [r * H / size, (r + 1) * H / size).

    Every rank sorts the whole cloud by depth; rank i takes the i-th of
    ``size`` equal chunks of the sorted splats, and sends each band its
    first ``budget`` covering splats (nearest first) as feature rows [pos,
    sh_dc, sh_rest (45), opacity, log_scale, quat, depth] by one
    all-to-all.  Each rank merges what it received by depth and renders its
    band (``render(**kw)``, K5 on the card) with the principal point moved
    up by the band's first row.  The bands are all-gathered, so every rank
    returns the whole image, on ``mesh.device``.

    ``budget=None`` sizes the budget from ``band_occupancy`` (a power of
    two, at least 256, at most a chunk): nothing is dropped.  An explicit
    budget is a hard cap; if it truncates, rank 0 prints how many
    splat-sends it dropped (the farthest first).  H must split into whole
    16-row tiles a rank, and N must divide by the mesh size.

    Unlike the JAX package, which renders every band's ``size * budget``
    rows, padding included (a unit-scale splat at the origin with opacity
    logit -30, which can take a window or global slot from a real
    candidate), each rank renders only the rows it really received.
    """
    nd = mesh.size
    h, w = cam.height, cam.width
    if h % (rz.TILE * nd):
        raise ValueError(f"sharded_render_tiles: {h} image rows do not split into whole "
                         f"{rz.TILE}-row tiles over {nd} ranks")
    rows_per = h // nd
    dev = mesh.device
    cl = _render_rows(cloud, dev)
    n = cl.pos.shape[0]
    per = _per_rank(n, mesh, "sharded_render_tiles")
    cam = cam.to(dev)
    sc = _render_rows(cl, dev, _depth_order(cl, cam))
    # the demand is measured on the depth-sorted chunks (what each sends)
    occ = band_occupancy(sc, cam, mesh)
    max_need = int(occ.max())
    if budget is None:
        budget = min(next_pow2(max_need, floor=256), n // nd)
    elif max_need > budget:
        dropped = int(torch.clamp(occ - budget, min=0).sum())
        if mesh.rank == 0:
            status_print(
                f"Warning: sharded_render_tiles budget={budget} saturated — "
                f"max band demand {max_need}; {dropped} farthest splat-sends "
                "truncated (pass budget=None to auto-size).")
    mine = _render_rows(sc, dev, slice(mesh.rank * per, (mesh.rank + 1) * per))
    with torch.no_grad():
        proj = project_gaussians(mine.pos, mine.log_scale, mine.quat, cam)
        covers = _band_covers(proj, h, rows_per, nd)
        budget_c = min(int(budget), per)
        # a splat's place among its band's covering splats, in depth order:
        # the first budget_c of each band are sent
        place = torch.cumsum(covers.to(torch.int32), 0) - 1
        src, band = torch.nonzero(covers & (place < budget_c), as_tuple=True)
        feats = torch.cat([mine.pos, mine.sh_dc, mine.sh_rest.reshape(per, -1),
                           mine.opacity[:, None], mine.log_scale, mine.quat,
                           proj["depth"][:, None], torch.ones(per, 1, device=dev)], 1)
        send = torch.zeros(nd, budget_c, feats.shape[1], device=dev)
        send[band, place[src, band]] = feats[src]
        got = _all_to_all(send, mesh).reshape(nd * budget_c, -1)
        got = got[got[:, -1] > 0]  # the rows really sent
        f = got[torch.argsort(got[:, -2], stable=True)]
    if f.shape[0] == 0:
        bg = kw.get("bg")
        bg = torch.zeros(3, device=dev) if bg is None else torch.as_tensor(
            bg, dtype=torch.float32, device=dev)
        band_img = bg.expand(rows_per, w, 3).contiguous()
    else:
        sub = cl.replace(pos=f[:, 0:3].contiguous(), sh_dc=f[:, 3:6].contiguous(),
                         sh_rest=f[:, 6:51].reshape(-1, 3, 15), opacity=f[:, 51].contiguous(),
                         log_scale=f[:, 52:55].contiguous(), quat=f[:, 55:59].contiguous())
        # this band's rows only: the principal point moved up by its first
        # row (in f32), as JAX does (the frustum clamp reads cy too)
        off = torch.tensor(float(mesh.rank * rows_per), dtype=torch.float32, device=dev)
        band_cam = dataclasses.replace(cam, cy=cam.cy - off, height=rows_per)
        band_img = rz.render(sub, band_cam, **kw)
    return _all_gather(band_img, mesh)

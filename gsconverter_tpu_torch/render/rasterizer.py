"""Tile-binned differentiable Gaussian-splat rasterizer.

The verification north star of BASELINE config 4: every conversion and
filter can be checked by rendered PSNR and pixel-gradient allclose, not
byte diffs.  The port of ``gsconverter_tpu/render/rasterizer.py``:
  1. project all splats (render/project.py);
  2. bin: for every 16x16 tile select the first ``max_per_tile``
     overlapping splats in depth order (tiered key binning, one sort);
  3. per-tile front-to-back alpha compositing in blocks of ``block_m``
     candidates, with an analytic backward (``_Composite``).

Compositing (``_Composite``) is the one hand-written part.  On a CUDA
tensor it launches kernel K5 (``composite_fwd``) and, in the backward,
K6 (``composite_bwd``) of ``csrc/composite.cu``, once for every tile of a
band; a build or launch failure raises.  On a CPU tensor it takes the
plain versions ``_composite_fwd_ref`` / ``_composite_bwd_ref``, the JAX
package's code in torch.  Everything else (projection, SH, binning, the
window gathers and their scatter-add backward) is torch ops.

Tracing (``utils/log.py``): ``render`` is a span (the root of a frame, or
inside a training step's) with ``project``, ``sh_color``, ``bin``, one
``band`` a compositing call (its ``tiles``, ``budget`` = the window a tile
gets, padded to ``block_m``, and ``slots`` = tiles x budget) and
``assemble``; under a band ``gather``, ``composite`` and the tile ids' two
blocking copies (``wait``, ``utils/transfer.py``).  The backward's
``composite_bwd`` carries its band's counters.  A render counts ``bands``
(on the card one K5 launch each), ``window_slots`` and the host's waits.

Exit semantics.  The plain path on the CPU runs JAX's chunk-wide early
exit: the tiles of one ``tile_chunk`` stop together once no pixel of any
of them has transmittance above ``T_EPS``.  On the card each tile stops on
its own (``per_tile``), which the plain versions also compute (a tile's
accumulators freeze once it saturates).  The two differ by at most
``T_EPS * (max color + max |bg|)`` per pixel.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..cloud import SplatCloud
from ..config import resolve_device
from ..ops import sh as sh_ops
from ..utils.log import count, span
from ..utils.transfer import to_host, upload
from .camera import Camera
from .project import project_gaussians

TILE = 16
PIXELS = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99

# chunk-level saturation threshold: once every pixel's transmittance is
# below this, the remaining (deeper) candidates cannot change the image by
# more than T_EPS — stop.  Bounded truncation error ~80 dB PSNR.
T_EPS = 1e-4
# safety factor on the saturation-depth budget's per-candidate effective
# alpha (auto_budget): the mean-pixel occlusion alpha * footprint integral /
# covered pixels, halved once, so pixels that see less than the mean still
# saturate before the budget cuts.
GAMMA_COVER = 0.5

# Binning tiers (windowed path).  A splat's tile span is ceil-bounded by
# its radius: radius <= TILE covers at most 3 tiles/axis, radius <= 3*TILE
# at most 7.  Smalls pay 9 key slots; mids are compacted to ``max_mid`` and
# pay 49; radius > 3*TILE giants (plus mid overflow) escape to a global
# candidate list injected into every tile.
R_SMALL_MAX = 1.0 * TILE
R_MID_MAX = 3.0 * TILE
SPAN_SMALL = 3
SPAN_MID = 7

#: block sizes the kernels take (candidates staged in shared memory)
MAX_BLOCK_M = 64
#: columns of the packed window row: mean (2), conic (3), color (3)
GEO = 8

#: launches of kernels K5 and K6 by their wrappers
LAUNCHES = {"composite_fwd": 0, "composite_bwd": 0}


# --------------------------------------------------------------- binning


def _tile_cover(means2d, radius, active, tw, th, span):
    """Covered-tile ids for each splat over a span x span window.

    Returns (tid [N, span*span] int64 with sentinel tw*th on uncovered
    slots, n_cov [N] covered-tile counts).  Coverage is the splat's disk
    (center, radius) against each tile's AABB.
    """
    n_tiles = tw * th
    dev = means2d.device
    mx, my = means2d[:, 0], means2d[:, 1]
    tx0i = torch.clamp(torch.floor((mx - radius) / TILE), 0, tw - 1).long()
    tx1i = torch.clamp(torch.floor((mx + radius) / TILE), 0, tw - 1).long()
    ty0i = torch.clamp(torch.floor((my - radius) / TILE), 0, th - 1).long()
    ty1i = torch.clamp(torch.floor((my + radius) / TILE), 0, th - 1).long()
    ar = torch.arange(span, device=dev)
    offs = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), -1).reshape(-1, 2)
    txs = tx0i[:, None] + offs[None, :, 1]
    tys = ty0i[:, None] + offs[None, :, 0]
    # nearest point of the tile AABB to the splat center
    f = means2d.dtype
    ndx = torch.clamp(mx[:, None], (txs * TILE).to(f), ((txs + 1) * TILE).to(f)) - mx[:, None]
    ndy = torch.clamp(my[:, None], (tys * TILE).to(f), ((tys + 1) * TILE).to(f)) - my[:, None]
    in_disk = ndx * ndx + ndy * ndy <= (radius * radius)[:, None]
    covered = ((txs <= tx1i[:, None]) & (tys <= ty1i[:, None]) & in_disk
               & active[:, None])
    tid = torch.where(covered, tys * tw + txs, n_tiles)
    return tid, covered.sum(1)


def _classify(radius, valid, max_mid):
    """Split splats into small / retained-mid / global tiers (masks).

    ``glob`` = true giants plus mids beyond the ``max_mid`` capacity
    (array order)."""
    small = valid & (radius <= R_SMALL_MAX)
    mid = valid & (radius > R_SMALL_MAX) & (radius <= R_MID_MAX)
    giant = valid & (radius > R_MID_MAX)
    mid_rank = torch.cumsum(mid.long(), 0) - 1
    keep_mid = mid & (mid_rank < max_mid)
    glob = giant | (mid & ~keep_mid)
    return small, keep_mid, glob


def _depth_bits(depth_key):
    """int64 sort key part that orders like ``depth_key`` (positive f32 or
    +inf: their int32 bit patterns order like the values)."""
    return depth_key.contiguous().view(torch.int32).long()


def _sort_by(major, bits):
    """Stable permutation sorting by (major, depth): one int64 key."""
    return torch.sort((major << 32) | bits, stable=True).indices


def _tiers(means2d, radius, valid, bits, max_mid, tw, th):
    """The tiered binning shared by ``render`` and ``_tile_occupancy``:
    the (category, depth) order, the retained mids and both tiers' covers."""
    n = radius.shape[0]
    dev = radius.device
    m_mid = min(max_mid, n)
    small, keep_mid, glob = _classify(radius, valid, max_mid)
    cat = torch.where(glob, 0, torch.where(keep_mid, 1, 2)).long()
    ids_cat = _sort_by(cat, bits)
    n_globc = glob.sum()
    # retained mids start right after the globals
    ids_pad = torch.cat([ids_cat, torch.zeros(m_mid, dtype=torch.long, device=dev)])
    sel_mid = ids_pad[n_globc + torch.arange(m_mid, device=dev)]
    mid_valid = torch.arange(m_mid, device=dev) < keep_mid.sum()
    tid_s, ncov_s = _tile_cover(means2d, radius.clamp_max(R_SMALL_MAX), small,
                                tw, th, SPAN_SMALL)
    tid_m, ncov_m = _tile_cover(means2d[sel_mid], radius[sel_mid], mid_valid,
                                tw, th, SPAN_MID)
    return dict(cat=cat, ids_cat=ids_cat, n_globc=n_globc, sel_mid=sel_mid,
                tid_s=tid_s, ncov_s=ncov_s, tid_m=tid_m, ncov_m=ncov_m)


def _bin_windowed(means2d, radius, valid, depth_key, max_global, max_mid, tw, th):
    """Sorted (tile, depth) entry array: ``(sorted_tid, entry_splat)``.

    Smalls emit 9 key slots, retained mids 49, and the front-most
    ``max_global`` globals are injected as keys into every tile, so they
    take window slots in depth position like any candidate.  Sort ties
    (equal depth in one tile) break by entry order, smalls by splat id.
    """
    n = radius.shape[0]
    dev = radius.device
    n_tiles = tw * th
    bits = _depth_bits(depth_key)
    t = _tiers(means2d, radius, valid, bits, max_mid, tw, th)
    n_glob = min(max_global, n)
    sel_g = t["ids_cat"][:n_glob]
    valid_g = t["cat"][sel_g] == 0
    sel_mid = t["sel_mid"]
    k_s, k_m = SPAN_SMALL * SPAN_SMALL, SPAN_MID * SPAN_MID
    tid_g = torch.where(valid_g[None, :],
                        torch.arange(n_tiles, device=dev)[:, None], n_tiles)
    tid_all = torch.cat([t["tid_s"].reshape(-1), t["tid_m"].reshape(-1),
                         tid_g.reshape(-1)])
    dep_all = torch.cat([bits[:, None].expand(n, k_s).reshape(-1),
                         bits[sel_mid][:, None].expand(-1, k_m).reshape(-1),
                         bits[sel_g][None, :].expand(n_tiles, n_glob).reshape(-1)])
    ids_all = torch.cat([torch.arange(n, device=dev)[:, None].expand(n, k_s).reshape(-1),
                         sel_mid[:, None].expand(-1, k_m).reshape(-1),
                         sel_g[None, :].expand(n_tiles, n_glob).reshape(-1)])
    order = _sort_by(tid_all, dep_all)
    return tid_all[order], ids_all[order]


# ----------------------------------------------------------- compositing


def _pixel_grid(origin):
    """Pixel centers [C, 256] (x, y) of tiles with top-left ``origin`` [C, 2]."""
    c_sz = origin.shape[0]
    px = torch.arange(TILE, dtype=origin.dtype, device=origin.device) + 0.5
    gx = (origin[:, 0, None, None] + px[None, None, :]).expand(c_sz, TILE, TILE)
    gy = (origin[:, 1, None, None] + px[None, :, None]).expand(c_sz, TILE, TILE)
    return gx.reshape(c_sz, PIXELS), gy.reshape(c_sz, PIXELS)


def _block_alpha(g_mean, g_conic, g_alpha, gx, gy):
    """Per-candidate alpha field over the tile pixels [C,BM,P] (+aux)."""
    dx = gx[:, None, :] - g_mean[:, :, 0:1]
    dy = gy[:, None, :] - g_mean[:, :, 1:2]
    power = -0.5 * (
        g_conic[:, :, 0:1] * dx * dx
        + 2.0 * g_conic[:, :, 1:2] * dx * dy
        + g_conic[:, :, 2:3] * dy * dy
    )
    gauss = torch.exp(power.clamp_max(0.0))
    raw = g_alpha[:, :, None] * gauss
    a = raw.clamp_max(ALPHA_MAX)
    a = torch.where(a < ALPHA_MIN, 0.0, a)
    return a, raw, gauss, power, dx, dy


def _blocks(bm, g_geo, g_alpha):
    c_sz, m = g_alpha.shape
    nb = m // bm
    return nb, g_geo.reshape(c_sz, nb, bm, GEO), g_alpha.reshape(c_sz, nb, bm)


def _composite_fwd_ref(bm, g_geo, g_alpha, origin, counts, bg, per_tile):
    """Plain version of K5 (JAX ``_composite_fwd_impl``).

    g_geo [C,M,8] (mean, conic, color), g_alpha [C,M] (0 on invalid
    slots), origin [C,2], counts [C], bg [3]; M a multiple of ``bm``.
    Returns rgb [C,256,3], t_starts [nb,C,256], t_final [C,256] and
    n_done [C] int32 (blocks composited).  ``per_tile=False`` stops the
    chunk as a whole (JAX), ``True`` each tile on its own (the kernel).
    """
    c_sz = g_alpha.shape[0]
    nb, geo, al = _blocks(bm, g_geo, g_alpha)
    gx, gy = _pixel_grid(origin)
    dt, dev = g_alpha.dtype, g_alpha.device
    nbt = torch.clamp((counts.long() + bm - 1) // bm, max=nb)
    nb_chunk = int(nbt.max()) if c_sz else 0
    rgb = torch.zeros(c_sz, PIXELS, 3, dtype=dt, device=dev)
    trans = torch.ones(c_sz, PIXELS, dtype=dt, device=dev)
    t_starts = torch.zeros(nb, c_sz, PIXELS, dtype=dt, device=dev)
    n_done = torch.zeros(c_sz, dtype=torch.int32, device=dev)
    for b in range(nb_chunk):
        if per_tile:
            act = (b < nbt) & (trans.amax(1) > T_EPS)
            if not bool(act.any()):
                break
        elif not float(trans.max()) > T_EPS:
            break
        blk = geo[:, b]
        a, _, _, _, _, _ = _block_alpha(blk[..., 0:2], blk[..., 2:5], al[:, b], gx, gy)
        tb = torch.cumprod(1.0 - a, dim=1)
        t_prev = torch.cat([torch.ones_like(tb[:, :1]), tb[:, :-1]], dim=1)
        wgt = a * t_prev * trans[:, None, :]
        t_starts[b] = trans
        new_rgb = rgb + torch.einsum("cmp,cmk->cpk", wgt, blk[..., 5:8])
        new_trans = trans * tb[:, -1, :]
        if per_tile:
            rgb = torch.where(act[:, None, None], new_rgb, rgb)
            trans = torch.where(act[:, None], new_trans, trans)
            n_done += act.to(torch.int32)
        else:
            rgb, trans = new_rgb, new_trans
            n_done += 1
    rgb = rgb + trans[:, :, None] * bg[None, None, :]
    return rgb, t_starts, trans, n_done


def _composite_bwd_ref(bm, g_geo, g_alpha, origin, bg, t_starts, t_final, n_done, grgb):
    """Plain version of K6 (JAX ``_composite_bwd``): walks each tile's
    blocks back to front from its ``n_done`` with the saved entry
    transmittances.  Returns d_geo [C,M,8], d_alpha [C,M], d_bg [3]."""
    c_sz, m = g_alpha.shape
    nb, geo, al = _blocks(bm, g_geo, g_alpha)
    gx, gy = _pixel_grid(origin)
    d_geo = torch.zeros(c_sz, nb, bm, GEO, dtype=g_geo.dtype, device=g_geo.device)
    d_al = torch.zeros(c_sz, nb, bm, dtype=g_geo.dtype, device=g_geo.device)
    R = torch.einsum("cpk,k->cp", grgb, bg) * t_final
    n_max = int(n_done.max()) if c_sz else 0
    for b in range(n_max - 1, -1, -1):
        on = b < n_done  # tiles that composited block b
        blk, ab = geo[:, b], al[:, b]
        cA, cB, cC = blk[..., 2:3], blk[..., 3:4], blk[..., 4:5]
        a, raw, gauss, power, dx, dy = _block_alpha(blk[..., 0:2], blk[..., 2:5], ab, gx, gy)
        tb = torch.cumprod(1.0 - a, dim=1)
        t_prev = torch.cat([torch.ones_like(tb[:, :1]), tb[:, :-1]], dim=1)
        T = t_starts[b][:, None, :] * t_prev  # exact forward T_i [C,BM,P]
        w = a * T
        cg = torch.einsum("cpk,cmk->cmp", grgb, blk[..., 5:8])  # (gbar . c_i)
        s = cg * w
        suffix = torch.sum(s, dim=1, keepdim=True) - torch.cumsum(s, dim=1)
        Ri = R[:, None, :] + suffix  # R_i = sum_{j>i} s_j
        d_a = cg * T - Ri / (1.0 - a)
        # clamp masks: a = min(alpha*G, 0.99) zeroed below 1/255
        live = (a >= ALPHA_MIN) & (raw < ALPHA_MAX)
        d_raw = torch.where(live, d_a, 0.0)
        d_gauss = d_raw * ab[:, :, None]
        d_power = torch.where(power < 0.0, d_gauss * gauss, 0.0)
        grads = torch.stack([
            torch.sum(d_power * (cA * dx + cB * dy), dim=2),
            torch.sum(d_power * (cB * dx + cC * dy), dim=2),
            torch.sum(d_power * (-0.5) * dx * dx, dim=2),
            torch.sum(d_power * (-1.0) * dx * dy, dim=2),
            torch.sum(d_power * (-0.5) * dy * dy, dim=2),
        ], dim=2)
        d_col = torch.einsum("cpk,cmp->cmk", grgb, w)
        d_geo[:, b] = torch.where(on[:, None, None], torch.cat([grads, d_col], 2), 0.0)
        d_al[:, b] = torch.where(on[:, None], torch.sum(d_raw * gauss, dim=2), 0.0)
        R = torch.where(on[:, None], R + torch.sum(s, dim=1), R)
    d_bg = torch.einsum("cpk,cp->k", grgb, t_final)
    return d_geo.reshape(c_sz, m, GEO), d_al.reshape(c_sz, m), d_bg


# ------------------------------------------------------ kernels K5 and K6

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib_fn(name: str, argtypes):
    """``name`` of the built ``csrc/composite.cu``, typed for ctypes."""
    from ..utils import cuda_build

    fn = getattr(cuda_build.load("composite"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_f32(name, t, shape):
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"compositing kernels take {name} as contiguous float32 "
                         f"{list(shape)}, got {t.dtype} {list(t.shape)}")


def _check_windows(bm, g_geo, g_alpha, origin, bg):
    if g_alpha.dim() != 2:
        raise ValueError(f"g_alpha must be [C, M], got {list(g_alpha.shape)}")
    c_sz, m = g_alpha.shape
    if not 1 <= bm <= MAX_BLOCK_M or m == 0 or m % bm:
        raise ValueError(f"compositing kernels take 1 <= block_m <= {MAX_BLOCK_M} "
                         f"dividing the window M; got block_m={bm}, M={m}")
    _check_f32("g_geo", g_geo, (c_sz, m, GEO))
    _check_f32("g_alpha", g_alpha, (c_sz, m))
    _check_f32("origin", origin, (c_sz, 2))
    _check_f32("bg", bg, (3,))
    devs = {t.device for t in (g_geo, g_alpha, origin, bg)}
    if len(devs) != 1:
        raise ValueError("compositing inputs lie on different devices")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"compositing runs on CUDA or CPU tensors, got {dev}")
    return dev


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _composite_fwd_kernel(bm, g_geo, g_alpha, origin, counts, bg):
    """Kernel K5: per-tile front-to-back compositing of every tile in one
    launch.  A CPU tensor takes the plain version with per-tile exit."""
    dev = _check_windows(bm, g_geo, g_alpha, origin, bg)
    c_sz, m = g_alpha.shape
    if counts.dtype != torch.int32 or tuple(counts.shape) != (c_sz,) \
            or not counts.is_contiguous() or counts.device != dev:
        raise ValueError(f"counts must be contiguous int32 [{c_sz}] on {dev}")
    if dev.type == "cpu":
        return _composite_fwd_ref(bm, g_geo, g_alpha, origin, counts, bg, per_tile=True)
    if g_geo.data_ptr() % 16:
        raise ValueError("K5 copies g_geo's rows 16 bytes at a time: g_geo must start "
                         "16-byte aligned")
    nb = m // bm
    rgb = torch.empty(c_sz, PIXELS, 3, dtype=torch.float32, device=dev)
    t_starts = torch.empty(nb, c_sz, PIXELS, dtype=torch.float32, device=dev)
    t_final = torch.empty(c_sz, PIXELS, dtype=torch.float32, device=dev)
    n_done = torch.empty(c_sz, dtype=torch.int32, device=dev)
    fn = _lib_fn("composite_fwd", [_P] * 9 + [_I] * 3 + [_P])
    with torch.cuda.device(dev):
        err = fn(g_geo.data_ptr(), g_alpha.data_ptr(), origin.data_ptr(),
                 counts.data_ptr(), bg.data_ptr(), rgb.data_ptr(), t_starts.data_ptr(),
                 t_final.data_ptr(), n_done.data_ptr(), c_sz, m, bm, _stream(g_geo))
    if err != 0:
        raise RuntimeError(f"composite_fwd (K5) launch failed with CUDA error {err}")
    LAUNCHES["composite_fwd"] += 1
    return rgb, t_starts, t_final, n_done


def _composite_bwd_kernel(bm, g_geo, g_alpha, origin, bg, t_starts, t_final, n_done, grgb):
    """Kernel K6: the analytic backward of K5 for every tile in one launch.
    Returns d_geo [C,M,8], d_alpha [C,M] and per-tile d_bg partials [C,3]
    (a CPU tensor takes the plain version, whose d_bg is [1,3])."""
    dev = _check_windows(bm, g_geo, g_alpha, origin, bg)
    c_sz, m = g_alpha.shape
    _check_f32("t_starts", t_starts, (m // bm, c_sz, PIXELS))
    _check_f32("t_final", t_final, (c_sz, PIXELS))
    _check_f32("grgb", grgb, (c_sz, PIXELS, 3))
    if n_done.dtype != torch.int32 or tuple(n_done.shape) != (c_sz,) \
            or not n_done.is_contiguous():
        raise ValueError(f"n_done must be contiguous int32 [{c_sz}]")
    if dev.type == "cpu":
        d_geo, d_al, d_bg = _composite_bwd_ref(bm, g_geo, g_alpha, origin, bg,
                                               t_starts, t_final, n_done, grgb)
        return d_geo, d_al, d_bg[None, :]
    d_geo = torch.zeros(c_sz, m, GEO, dtype=torch.float32, device=dev)
    d_al = torch.zeros(c_sz, m, dtype=torch.float32, device=dev)
    d_bg = torch.empty(c_sz, 3, dtype=torch.float32, device=dev)
    fn = _lib_fn("composite_bwd", [_P] * 11 + [_I] * 3 + [_P])
    with torch.cuda.device(dev):
        err = fn(g_geo.data_ptr(), g_alpha.data_ptr(), origin.data_ptr(), bg.data_ptr(),
                 grgb.data_ptr(), t_starts.data_ptr(), t_final.data_ptr(),
                 n_done.data_ptr(), d_geo.data_ptr(), d_al.data_ptr(), d_bg.data_ptr(),
                 c_sz, m, bm, _stream(g_geo))
    if err != 0:
        raise RuntimeError(f"composite_bwd (K6) launch failed with CUDA error {err}")
    LAUNCHES["composite_bwd"] += 1
    return d_geo, d_al, d_bg


class _Composite(torch.autograd.Function):
    """Front-to-back alpha compositing of depth-ordered candidates.

    The analytic backward walks the blocks back to front with the
    per-block entry transmittances saved by the forward (block-exact: no
    1/(1-a) transmittance reconstruction).  CUDA tensors: K5 and K6 (exit
    per tile, always); CPU tensors: the plain versions, chunk-wide exit
    unless ``per_tile``."""

    @staticmethod
    def forward(ctx, g_geo, g_alpha, bg, origin, counts, bm, per_tile):
        if g_geo.device.type == "cuda":
            rgb, t_starts, t_final, n_done = _composite_fwd_kernel(
                bm, g_geo, g_alpha, origin, counts, bg)
        else:
            rgb, t_starts, t_final, n_done = _composite_fwd_ref(
                bm, g_geo, g_alpha, origin, counts, bg, per_tile)
        ctx.save_for_backward(g_geo, g_alpha, bg, origin, t_starts, t_final, n_done)
        ctx.bm = bm
        return rgb

    @staticmethod
    def backward(ctx, grgb):
        g_geo, g_alpha, bg, origin, t_starts, t_final, n_done = ctx.saved_tensors
        c_sz, m = g_alpha.shape
        with span("composite_bwd", tiles=c_sz, budget=m, slots=c_sz * m):
            grgb = grgb.contiguous()
            if g_geo.device.type == "cuda":
                d_geo, d_al, d_bg = _composite_bwd_kernel(ctx.bm, g_geo, g_alpha, origin, bg,
                                                          t_starts, t_final, n_done, grgb)
                d_bg = d_bg.sum(0)
            else:
                d_geo, d_al, d_bg = _composite_bwd_ref(ctx.bm, g_geo, g_alpha, origin, bg,
                                                       t_starts, t_final, n_done, grgb)
        return d_geo, d_al, d_bg, None, None, None, None


def _composite(bm, g_geo, g_alpha, origin, counts, bg, per_tile=True):
    """rgb [C,256,3] of the windows (differentiable in g_geo, g_alpha, bg)."""
    return _Composite.apply(g_geo, g_alpha, bg, origin, counts, bm, per_tile)


# ---------------------------------------------------------------- render


def _render_device(cloud: SplatCloud, device) -> torch.device:
    """Where a render of ``cloud`` runs: a tensor cloud's own device; a
    host cloud's ``resolve_device(device)`` (the card unless "cpu")."""
    if cloud.is_host:
        return resolve_device(device)
    dev = cloud.pos.device
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None and want.index != dev.index):
            raise ValueError(f"the cloud's tensors lie on {dev}, not on {want}")
    return dev


def _leaves_on(cloud: SplatCloud, dev: torch.device) -> SplatCloud:
    """The render leaves as float32 tensors on ``dev`` (tensors keep their
    autograd history)."""

    def conv(a):
        return upload(a if isinstance(a, torch.Tensor)
                      else np.ascontiguousarray(a, dtype=np.float32), dev)

    return cloud.replace(**{k: conv(getattr(cloud, k)) for k in
                            ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat")})


def _launch_groups(n_tiles, tile_chunk, on_card, windowed, max_per_tile, n,
                   tile_order, band_plan, span=None):
    """[(out_ids, render_ids, budget)] of int64 host arrays: one group per
    compositing call.  On the CPU the groups are ``tile_chunk`` tiles (JAX's
    chunks, pads included, so the chunk-wide exit matches); on the card a
    windowed band is one group (one K5/K6 launch), exact binning keeps
    ``tile_chunk`` groups to bound its [tiles, N] selection.  ``span``
    (t0, t1) takes tiles [t0, t1) only (no band plan)."""
    if band_plan is not None:
        order = to_host(tile_order).astype(np.int64)
        bands, off = [], 0
        for nc, mb in band_plan:
            bands.append((order[off:off + nc * tile_chunk], min(int(mb), n)))
            off += nc * tile_chunk
    else:
        t0, t1 = (0, n_tiles) if span is None else span
        chunks = -(-(t1 - t0) // tile_chunk)
        ids = np.arange(t0, t1, dtype=np.int64)
        if not on_card:
            # JAX pads the last chunk with tile 0 (rendered, then dropped)
            ids = np.concatenate([ids, np.full(chunks * tile_chunk - (t1 - t0), n_tiles)])
        bands = [(ids, max_per_tile)]
    groups = []
    for ids, budget in bands:
        if on_card:
            ids = ids[ids < n_tiles]
            step = len(ids) if windowed else tile_chunk
            for s in range(0, len(ids), max(step, 1)):
                groups.append((ids[s:s + step], ids[s:s + step], budget))
        else:
            # pads (id n_tiles) land in the dropped extra row; band pads
            # render tile n_tiles - 1, chunk pads tile 0, as in JAX
            safe = np.where(ids < n_tiles, ids, n_tiles - 1 if band_plan is not None else 0)
            for s in range(0, len(ids), tile_chunk):
                groups.append((ids[s:s + tile_chunk], safe[s:s + tile_chunk], budget))
    return groups


def render(
    cloud: SplatCloud,
    cam: Camera,
    bg=None,
    max_per_tile: int = 256,
    tile_chunk: int = 32,
    sh_degree: int | None = None,
    binning: str = "windowed",
    max_global: int = 32,
    block_m: int = 32,
    max_mid: int = 16384,
    tile_order=None,
    band_plan: tuple | None = None,
    rows: tuple[int, int] | None = None,
    device=None,
) -> torch.Tensor:
    """Render [H,W,3] linear-RGB image. Differentiable w.r.t. all splat params.

    binning="windowed": production path (default) — tiered key binning:
                        splats with radius <= 1 tile emit 9 key slots,
                        radius <= 3 tiles are compacted to ``max_mid`` and
                        emit 49 slots, one stable sort groups all keys by
                        tile in depth order, per-tile candidate windows are
                        fixed [max_per_tile] slices.  Only radius > 3-tile
                        giants (and mid-capacity overflow) escape to a
                        global candidate list (front-most ``max_global`` by
                        depth) injected into every tile's key run.  As in
                        the JAX package, those injected globals TAKE
                        ``max_per_tile`` window slots like any candidate:
                        in a tile whose run exceeds the budget they can
                        displace deeper candidates.
    binning="exact":    per-tile overlap over ALL splats (O(tiles*N) select) —
                        the verification oracle path.

    ``tile_order`` + ``band_plan`` (from :func:`auto_budget` /
    :func:`plan_bands`) switch on occupancy-banded scheduling: tiles are
    processed grouped by their measured candidate need, each band with its
    own (pow2) budget.  ``band_plan`` is a tuple of ``(n_chunks, budget)``
    per band; ``tile_order`` the matching concatenation of per-band tile
    ids, each band padded to a multiple of ``tile_chunk`` with the sentinel
    ``n_tiles``.

    ``rows=(r0, r1)`` (multiples of 16, no band plan) composites only the
    tiles of image rows [r0, r1) and returns those rows [r1 - r0, W, 3]:
    the projection and binning stay the whole image's, so each tile gets
    the candidates it gets in the whole image (a band camera's frustum
    clamp would move the splats' footprints).

    Runs where the cloud's tensors live; a host cloud (numpy leaves) goes
    to ``resolve_device(device)``, the card unless ``device="cpu"``.  On
    the card each band's compositing is one launch of K5 (and of K6 in the
    backward), with ``1 <= block_m <= 64``; on the CPU ``tile_chunk`` tiles
    at a time with JAX's chunk-wide early exit.
    """
    with span("render"):
        if binning not in ("windowed", "exact"):
            raise ValueError(f"binning must be 'windowed' or 'exact', got {binning!r}")
        if band_plan is not None and (binning != "windowed" or tile_order is None):
            raise ValueError("band_plan requires windowed binning + tile_order")
        if rows is not None and band_plan is not None:
            raise ValueError("rows and band_plan do not combine")
        dev = _render_device(cloud, device)
        cl = _leaves_on(cloud, dev)
        cam = cam.to(dev)
        h, w = cam.height, cam.width
        if h % TILE or w % TILE:
            raise ValueError("image dims must be multiples of 16")
        tw, th = w // TILE, h // TILE
        n_tiles = tw * th
        r0, r1 = (0, h) if rows is None else (int(rows[0]), int(rows[1]))
        if r0 % TILE or r1 % TILE or not 0 <= r0 < r1 <= h:
            raise ValueError(f"rows must be multiples of {TILE} within [0, {h}], got {rows}")
        tiles_span = (r0 // TILE * tw, r1 // TILE * tw)
        n = cl.pos.shape[0]
        max_per_tile = min(max_per_tile, n)
        bg = (torch.zeros(3, device=dev) if bg is None
              else upload(torch.as_tensor(bg, dtype=torch.float32), dev))
        on_card = dev.type == "cuda"

        with span("project"):
            proj = project_gaussians(cl.pos, cl.log_scale, cl.quat, cam)
        with span("sh_color"):
            color = sh_ops.eval_sh(
                cl, proj["view_dir"], cl.active_sh_degree if sh_degree is None else sh_degree,
            ).clamp_min(0.0)  # [N,3] linear
            alpha = torch.sigmoid(cl.opacity)
        with span("bin"):
            depth_key = torch.where(proj["in_front"], proj["depth"], torch.inf).detach()
            means2d, conic, radius = proj["means2d"], proj["conic"], proj["radius"].detach()
            valid = proj["in_front"]
            if binning == "windowed":
                # depth rides as the second part of the sort key: per-tile runs
                # come out front to back without reordering the attribute arrays
                sorted_tid, entry_splat = _bin_windowed(
                    means2d.detach(), radius, valid, depth_key, max_global, max_mid, tw, th)
            else:
                # exact oracle path: selection by index needs depth-sorted arrays
                order = torch.argsort(depth_key, stable=True)
                means2d, conic, radius = means2d[order], conic[order], radius[order]
                valid, color, alpha = valid[order], color[order], alpha[order]
                m2 = means2d.detach()
                lo_x, hi_x = m2[:, 0] - radius, m2[:, 0] + radius
                lo_y, hi_y = m2[:, 1] - radius, m2[:, 1] + radius
                neg_idx = -torch.arange(n, device=dev, dtype=torch.float32)

            tix = torch.arange(n_tiles, device=dev)
            x0 = ((tix % tw) * TILE).float()
            y0 = ((tix // tw) * TILE).float()
            # one row gather for geometry + color; alpha a separate column, so a
            # loss differentiated w.r.t. opacity alone scatters one column
            packed = torch.cat([means2d, conic, color], dim=1)  # [N, 8]

        def select(tile_idx, budget):
            if binning == "windowed":
                start = torch.searchsorted(sorted_tid, tile_idx, right=False)
                end = torch.searchsorted(sorted_tid, tile_idx, right=True)
                idx = start[:, None] + torch.arange(budget, device=dev)[None, :]
                w_valid = idx < end[:, None]
                idx = idx.clamp(0, sorted_tid.shape[0] - 1)
                ids = torch.where(w_valid, entry_splat[idx], n)
                counts = torch.clamp(end - start, max=budget)
                return ids.clamp(0, n - 1), ids < n, counts
            tx0, ty0 = x0[tile_idx], y0[tile_idx]
            overlap = ((hi_x[None, :] >= tx0[:, None]) & (lo_x[None, :] <= tx0[:, None] + TILE)
                       & (hi_y[None, :] >= ty0[:, None]) & (lo_y[None, :] <= ty0[:, None] + TILE)
                       & valid[None, :])  # [C, N]
            # first max_per_tile in depth order: score = -index where overlapping
            score = torch.where(overlap, neg_idx[None, :], -torch.inf)
            sel = torch.topk(score, max_per_tile, dim=1).indices  # ascending depth
            sel_valid = torch.gather(overlap, 1, sel)
            return sel, sel_valid, sel_valid.sum(1)

        def bin_and_render(tile_idx, budget):
            with span("gather"):
                sel, sel_valid, counts = select(tile_idx, budget)
                pad = -sel.shape[1] % block_m
                if pad:
                    sel = torch.nn.functional.pad(sel, (0, pad))
                    sel_valid = torch.nn.functional.pad(sel_valid, (0, pad))
                # index_select: its backward is index_add_ (one atomic add an
                # entry), where packed[sel]'s index_put_ sorts every index first
                flat = sel.reshape(-1)
                g_geo = packed.index_select(0, flat).view(*sel.shape, GEO)  # [C, M', 8]
                g_alpha = torch.where(sel_valid, alpha.index_select(0, flat).view(sel.shape), 0.0)
                origin = torch.stack([x0[tile_idx], y0[tile_idx]], dim=1)
            with span("composite"):
                rgb = _composite(block_m, g_geo, g_alpha, origin, counts.to(torch.int32), bg,
                                 per_tile=on_card)
            return rgb.reshape(-1, TILE, TILE, 3)

        out_ids, tiles = [], []
        for ids_out, ids_render, budget in _launch_groups(
                n_tiles, tile_chunk, on_card, binning == "windowed", max_per_tile, n,
                tile_order, band_plan, tiles_span):
            if len(ids_render):
                # each tile's window: ``budget`` slots padded to whole blocks
                window = budget + -budget % block_m
                slots = len(ids_render) * window
                count(bands=1, window_slots=slots)
                with span("band", tiles=len(ids_render), budget=window, slots=slots):
                    tiles.append(bin_and_render(upload(ids_render, dev), budget))
                    out_ids.append(upload(ids_out, dev))
        with span("assemble"):
            out = torch.zeros(n_tiles + 1, TILE, TILE, 3, dtype=torch.float32, device=dev)
            # pad entries (id == n_tiles) land in the dropped extra row
            out = out.index_put((torch.cat(out_ids),), torch.cat(tiles))
            band_th = (r1 - r0) // TILE
            img = out[tiles_span[0]:tiles_span[1]].reshape(band_th, tw, TILE, TILE, 3)
            return img.permute(0, 2, 1, 3, 4).reshape(r1 - r0, w, 3)


# ------------------------------------------------------- budget planning


def _tile_occupancy(pos, log_scale, quat, opacity, cam: Camera,
                    saturation: bool = True, max_mid: int = 16384):
    """Per-tile windowed-candidate counts, global-escape count and, with
    ``saturation``, each tile's saturation depth: the number of
    depth-ordered candidates before a conservative tile-level transmittance
    bound falls below T_EPS.  Mirrors the renderer's tiered binning.
    Returns (counts [T], n_glob 0-d, k_sat [T]) as tensors."""
    with torch.no_grad():
        h, w = cam.height, cam.width
        tw, th = w // TILE, h // TILE
        n_tiles = tw * th
        proj = project_gaussians(pos, log_scale, quat, cam)
        means2d, radius, valid = proj["means2d"], proj["radius"], proj["in_front"]
        depth_key = torch.where(valid, proj["depth"], torch.inf)
        bits = _depth_bits(depth_key)
        n = means2d.shape[0]
        m_mid = min(max_mid, n)
        t = _tiers(means2d, radius, valid, bits, m_mid, tw, th)
        sel_mid = t["sel_mid"]
        tid_all = torch.cat([t["tid_s"].reshape(-1), t["tid_m"].reshape(-1)])
        counts = torch.bincount(tid_all.clamp(0, n_tiles), minlength=n_tiles + 1)
        if not saturation:
            return counts[:n_tiles], t["n_globc"], counts[:n_tiles]
        # per-entry mean-pixel occlusion: the integrated footprint
        # 2*pi*sigma^2 (sigma = radius/3 px) spread over the covered tiles
        alpha = torch.sigmoid(opacity)

        def occl(rad, ncov):
            return torch.clamp_max(
                (2.0 * math.pi / 9.0) * rad * rad
                / (float(TILE * TILE) * ncov.clamp_min(1)), 1.0)

        k_s, k_m = SPAN_SMALL * SPAN_SMALL, SPAN_MID * SPAN_MID
        a_s = alpha * occl(radius.clamp_max(R_SMALL_MAX), t["ncov_s"])
        a_m = alpha[sel_mid] * occl(radius[sel_mid], t["ncov_m"])
        a_ent = torch.cat([a_s[:, None].expand(n, k_s).reshape(-1),
                           a_m[:, None].expand(-1, k_m).reshape(-1)])
        dep_ent = torch.cat([bits[:, None].expand(n, k_s).reshape(-1),
                             bits[sel_mid][:, None].expand(-1, k_m).reshape(-1)])
        order = _sort_by(tid_all, dep_ent)
        sorted_tid, a_sorted = tid_all[order], a_ent[order]
        real = sorted_tid < n_tiles
        l = torch.where(real, torch.log1p(-GAMMA_COVER * a_sorted.clamp_max(0.99)), 0.0)
        ecs = torch.cumsum(l, 0) - l  # exclusive global prefix
        first_idx = torch.searchsorted(sorted_tid, torch.arange(n_tiles, device=pos.device))
        bases = ecs[first_idx.clamp(0, sorted_tid.shape[0] - 1)]
        pre = ecs - bases[sorted_tid.clamp(0, n_tiles - 1)]
        log_eps = torch.log(torch.tensor(T_EPS, dtype=torch.float32, device=pos.device))
        contributing = real & (pre > log_eps)
        k_sat = torch.zeros(n_tiles + 1, dtype=torch.long, device=pos.device)
        k_sat.index_add_(0, sorted_tid.clamp(0, n_tiles), contributing.long())
        return counts[:n_tiles], t["n_globc"], k_sat[:n_tiles]


def plan_bands(needed: np.ndarray, tile_chunk: int = 64, cap: int = 1024,
               min_budget: int = 32) -> tuple[np.ndarray, tuple]:
    """Host-side occupancy banding for :func:`render`.

    Groups tiles by the pow2-rounded budget each NEEDS (from
    :func:`auto_budget`'s per-tile ``needed`` counts), densest band first,
    tiles within a band ordered by descending need so each ``tile_chunk``
    is occupancy-homogeneous.  Each band is padded to a multiple of
    ``tile_chunk`` with the sentinel ``n_tiles``.

    Returns ``(tile_order int32 [sum bands], band_plan)`` where
    ``band_plan`` is a tuple of ``(n_chunks, budget)``.
    """
    needed = np.asarray(needed)
    n_tiles = needed.shape[0]
    clipped = np.minimum(np.maximum(needed.astype(np.int64), 1), cap)
    budg = np.maximum(
        min_budget, 1 << np.ceil(np.log2(clipped)).astype(np.int64)
    )
    budg = np.minimum(budg, cap)
    order_all = np.argsort(-needed, kind="stable")
    parts, plan = [], []
    for bv in sorted(set(budg.tolist()), reverse=True):
        ids = order_all[budg[order_all] == bv]
        pad = (-len(ids)) % tile_chunk
        ids = np.concatenate([ids, np.full(pad, n_tiles, dtype=np.int64)])
        parts.append(ids)
        plan.append((len(ids) // tile_chunk, int(bv)))
    return np.concatenate(parts).astype(np.int32), tuple(plan)


def auto_budget(cloud: SplatCloud, cam: Camera, cap: int = 1024,
                glob_cap: int = 256, saturation: bool = True,
                max_mid: int = 16384, band_chunk: int | None = None,
                device=None) -> dict:
    """Measure the scene's per-tile candidate occupancy and size the
    render budgets from it.

    With ``saturation`` (default), each tile's NEEDED budget is capped at
    2x its measured depth-to-saturation + 32.  Returns a dict with
    ``max_per_tile`` / ``max_global`` (pow2, capped) plus the report:
    ``occ_max``, ``occ_mean``, ``n_big`` (the global-escape population),
    ``sat_max``, ``truncated_tiles`` (tiles the chosen budget truncates
    beyond the saturation-justified point) and ``big_truncated``.  With
    ``band_chunk`` set, also ``tile_order`` / ``band_plan`` from
    :func:`plan_bands`.  Runs where :func:`render` would.
    """
    dev = _render_device(cloud, device)
    cl = _leaves_on(cloud, dev)
    counts, n_big, k_sat = _tile_occupancy(
        cl.pos, cl.log_scale, cl.quat, cl.opacity, cam.to(dev),
        saturation=saturation, max_mid=max_mid)
    counts = to_host(counts)
    k_sat = to_host(k_sat)
    n_big = int(n_big)
    g = 32
    while g < n_big and g < glob_cap:
        g *= 2
    # the renderer injects the global candidates into every tile's window
    n = cl.pos.shape[0]
    counts = counts + min(n_big, min(g, n))
    occ_max = int(counts.max()) if counts.size else 0
    if saturation:
        needed = np.minimum(counts, 2 * k_sat + 32 + min(n_big, min(g, n)))
    else:
        needed = counts
    need_max = int(needed.max()) if needed.size else 0
    m = 32
    while m < need_max and m < cap:
        m *= 2
    out = dict(
        max_per_tile=m,
        max_global=g,
        occ_max=occ_max,
        occ_mean=float(counts.mean()) if counts.size else 0.0,
        n_big=n_big,
        sat_max=int(k_sat.max()) if saturation and k_sat.size else None,
        truncated_tiles=int((needed > m).sum()),
        big_truncated=max(0, n_big - g),
    )
    if band_chunk is not None:
        out["tile_order"], out["band_plan"] = plan_bands(
            needed, tile_chunk=band_chunk, cap=cap
        )
    return out


def render_reference(cloud: SplatCloud, cam: Camera, bg=None, sh_degree=None,
                     device=None) -> torch.Tensor:
    """Naive per-pixel-over-all-splats renderer (no binning, no budget).

    The ground-truth oracle for the tiled renderer's forward and pixel
    gradients (BASELINE config 4).  O(H*W*N) memory — tiny scenes only.
    """
    dev = _render_device(cloud, device)
    cl = _leaves_on(cloud, dev)
    cam = cam.to(dev)
    h, w = cam.height, cam.width
    bg = (torch.zeros(3, device=dev) if bg is None
          else torch.as_tensor(bg, dtype=torch.float32, device=dev))
    proj = project_gaussians(cl.pos, cl.log_scale, cl.quat, cam)
    color = sh_ops.eval_sh(
        cl, proj["view_dir"], cl.active_sh_degree if sh_degree is None else sh_degree,
    ).clamp_min(0.0)
    alpha = torch.sigmoid(cl.opacity)
    order = torch.argsort(torch.where(proj["in_front"], proj["depth"], torch.inf).detach(),
                          stable=True)
    means2d = proj["means2d"][order]
    conic = proj["conic"][order]
    valid = proj["in_front"][order]
    color = color[order]
    alpha = torch.where(valid, alpha[order], 0.0)

    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij",
    )
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=1)  # [P,2]
    dx = pix[None, :, 0] - means2d[:, 0:1]
    dy = pix[None, :, 1] - means2d[:, 1:2]
    power = -0.5 * (
        conic[:, 0:1] * dx * dx + 2.0 * conic[:, 1:2] * dx * dy + conic[:, 2:3] * dy * dy
    )
    a = torch.clamp_max(alpha[:, None] * torch.exp(power.clamp_max(0.0)), ALPHA_MAX)
    a = torch.where(a < ALPHA_MIN, 0.0, a)  # [N,P]
    trans = torch.cumprod(1.0 - a, dim=0)
    t_prev = torch.cat([torch.ones_like(trans[:1]), trans[:-1]], dim=0)
    wgt = a * t_prev
    rgb = torch.einsum("np,nk->pk", wgt, color) + trans[-1][:, None] * bg[None, :]
    return rgb.reshape(h, w, 3)


def psnr(a: torch.Tensor, b: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    mse = torch.mean((a - b) ** 2)
    return 10.0 * torch.log10(peak * peak / torch.clamp_min(mse, 1e-12))

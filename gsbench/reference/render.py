"""Plain PyTorch reference of the tile renderer and of an Adam step on it.

The semantics it follows are 3DGS's (Kerbl et al. 2023,
arXiv:2308.04079) as the port's renderer states them:

- EWA projection with a 0.3-pixel dilation and 1.3x frustum clamp; color
  0.5 plus the real spherical harmonics of the splat's degree (3DGS's
  basis, up to degree 3) at the unit direction from the camera's center
  to the splat, clamped at 0; alpha = sigmoid(opacity).
- Binning into 16 x 16 tiles by tiers: splats of radius <= 16 px cover a 3 x
  3 tile span, radius <= 48 px (the first ``max_mid`` in array order) a 7 x
  7 span, each tested disk against tile box; the rest are global and the
  front-most ``max_global`` join every tile.  A tile's candidates are
  ordered by (depth, tier, splat id) and cut at the tile's budget.
- The budget of a tile (the render settings' ``auto_budget``): its
  candidate count, capped at twice the depth at which a conservative
  tile-level transmittance bound falls under 1e-4, plus 32 and the global
  count, rounded up to a power of two between 32 and ``cap``.
- Front-to-back compositing in blocks of ``block_m`` candidates; alpha =
  min(0.99, a * exp(min(power, 0))), set to 0 under 1/255; a tile stops
  at a block boundary once no pixel's transmittance exceeds 1e-4.

Projection, binning and budget repeat the float32 operations in their
stated order, so every binning decision is the one the port's arithmetic
makes; compositing runs block by block in plain operations in ``dtype``,
and its gradient comes from autograd.  Runs on whatever device the
tensors are on, in tile groups so that it fits beside nothing else.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TILE = 16
PIXELS = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
DILATION = 0.3
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
R_SMALL, R_MID = 16.0, 48.0
SPAN_SMALL, SPAN_MID = 3, 7
GAMMA_COVER = 0.5


class Camera:
    """A pinhole camera looking from ``eye`` at ``target``: world-to-camera
    rows (right, down, forward), focal length from the horizontal field of
    view, principal point at the image center; matrices formed in float32."""

    def __init__(self, eye, target, up, fov_deg, width, height, device):
        eye, target, up = (np.asarray(v, np.float32) for v in (eye, target, up))
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        rot = np.stack([right, down, fwd], axis=0)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = rot
        w2c[:3, 3] = -rot @ eye
        f = 0.5 * width / np.tan(np.radians(fov_deg) / 2)

        def t(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

        self.w2c = t(w2c)
        self.center = -self.w2c[:3, :3].T @ self.w2c[:3, 3]
        self.fx, self.fy = t(f), t(f)
        self.cx, self.cy = t(width / 2), t(height / 2)
        self.width, self.height = int(width), int(height)


def _mm3(a, b):
    """Products of small matrices as a broadcast multiply and a sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def sh_color(p: dict, dirs, degree: int):
    """0.5 plus the SH of ``degree`` at unit directions ``dirs`` [N, 3]:
    linear RGB [N, 3], not yet clamped (3DGS's ``eval_sh``; ``sh_rest``
    [N, 3, 15] holds coefficients 1-15 of each channel)."""
    c = SH_C0 * p["sh_dc"]
    if degree >= 1:
        sh = p["sh_rest"]
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        c = c - SH_C1 * y * sh[:, :, 0] + SH_C1 * z * sh[:, :, 1] - SH_C1 * x * sh[:, :, 2]
        if degree >= 2:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            c = (c + SH_C2[0] * xy * sh[:, :, 3] + SH_C2[1] * yz * sh[:, :, 4]
                 + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, :, 5]
                 + SH_C2[3] * xz * sh[:, :, 6] + SH_C2[4] * (xx - yy) * sh[:, :, 7])
            if degree >= 3:
                c = (c + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, :, 8]
                     + SH_C3[1] * xy * z * sh[:, :, 9]
                     + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, :, 10]
                     + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, :, 11]
                     + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, :, 12]
                     + SH_C3[5] * z * (xx - yy) * sh[:, :, 13]
                     + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, :, 14])
    return c + 0.5


def project(p: dict, cam: Camera, degree: int) -> dict:
    """Screen-space splats of the parameter tensors ``p`` (differentiable),
    colored by their SH up to ``degree``."""
    R, t = cam.w2c[:3, :3], cam.w2c[:3, 3]
    p_cam = p["pos"] @ R.T + t[None, :]
    z = p_cam[:, 2]
    valid = z > 0.01
    zc = z.clamp_min(0.01)
    means2d = torch.stack([cam.fx * p_cam[:, 0] / zc + cam.cx,
                           cam.fy * p_cam[:, 1] / zc + cam.cy], dim=1)
    lim_x = 1.3 * cam.cx / cam.fx
    lim_y = 1.3 * cam.cy / cam.fy
    tx = torch.clamp(p_cam[:, 0] / zc, -lim_x, lim_x) * zc
    ty = torch.clamp(p_cam[:, 1] / zc, -lim_y, lim_y) * zc
    zero = torch.zeros_like(zc)
    J = torch.stack([
        torch.stack([cam.fx / zc, zero, -cam.fx * tx / (zc * zc)], -1),
        torch.stack([zero, cam.fy / zc, -cam.fy * ty / (zc * zc)], -1),
    ], dim=1)
    q = p["quat"]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, zq = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq), 2 * (x * zq + w * y)], -1),
        torch.stack([2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - w * x)], -1),
        torch.stack([2 * (x * zq - w * y), 2 * (y * zq + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=1)
    rs = rot * torch.exp(p["log_scale"])[:, None, :]
    cov3d = _mm3(rs, rs.transpose(1, 2))
    W = R[None, :, :]
    cov2d = _mm3(_mm3(J, _mm3(_mm3(W, cov3d), W.transpose(1, 2))), J.transpose(1, 2))
    cov2d = cov2d + DILATION * torch.eye(2, dtype=cov2d.dtype, device=cov2d.device)[None]
    det = (cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] ** 2).clamp_min(1e-12)
    conic = torch.stack([cov2d[:, 1, 1] / det, -cov2d[:, 0, 1] / det,
                         cov2d[:, 0, 0] / det], dim=1)
    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    lam1 = mid + torch.sqrt((mid * mid - det).clamp_min(0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    dirs = p["pos"] - cam.center[None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True).clamp_min(1e-12)
    color = sh_color(p, dirs, degree).clamp_min(0.0)
    return dict(means2d=means2d, conic=conic, depth=z, radius=radius.detach(),
                valid=valid, color=color, alpha=torch.sigmoid(p["opacity"]))


# ------------------------------------------------------------------ binning


def _cover(means2d, radius, active, tw, th, span):
    """(tile ids [N, span*span], sentinel tw*th where a slot covers no
    tile; covered counts [N]): the splat's disk against each tile's box."""
    n_tiles = tw * th
    mx, my = means2d[:, 0], means2d[:, 1]
    tx0 = torch.clamp(torch.floor((mx - radius) / TILE), 0, tw - 1).long()
    tx1 = torch.clamp(torch.floor((mx + radius) / TILE), 0, tw - 1).long()
    ty0 = torch.clamp(torch.floor((my - radius) / TILE), 0, th - 1).long()
    ty1 = torch.clamp(torch.floor((my + radius) / TILE), 0, th - 1).long()
    ar = torch.arange(span, device=mx.device)
    oy, ox = torch.meshgrid(ar, ar, indexing="ij")
    txs = tx0[:, None] + ox.reshape(1, -1)
    tys = ty0[:, None] + oy.reshape(1, -1)
    f = means2d.dtype
    ndx = torch.clamp(mx[:, None], (txs * TILE).to(f), ((txs + 1) * TILE).to(f)) - mx[:, None]
    ndy = torch.clamp(my[:, None], (tys * TILE).to(f), ((tys + 1) * TILE).to(f)) - my[:, None]
    hit = ((txs <= tx1[:, None]) & (tys <= ty1[:, None])
           & (ndx * ndx + ndy * ndy <= (radius * radius)[:, None]) & active[:, None])
    return torch.where(hit, tys * tw + txs, n_tiles), hit.sum(1)


def _key_sort(major, minor_bits):
    return torch.sort((major << 32) | minor_bits, stable=True).indices


def _tiers(proj, max_mid, tw, th):
    """The tier split, the (tier, depth) order, the kept mids and both
    tiers' covers."""
    radius, valid = proj["radius"], proj["valid"]
    m2 = proj["means2d"].detach()
    n = radius.shape[0]
    dev = radius.device
    depth = torch.where(valid, proj["depth"].detach(), torch.inf)
    bits = depth.contiguous().view(torch.int32).long()
    small = valid & (radius <= R_SMALL)
    mid = valid & (radius > R_SMALL) & (radius <= R_MID)
    keep_mid = mid & (torch.cumsum(mid.long(), 0) - 1 < max_mid)
    glob = (valid & (radius > R_MID)) | (mid & ~keep_mid)
    tier = torch.where(glob, 0, torch.where(keep_mid, 1, 2)).long()
    by_tier = _key_sort(tier, bits)
    m_mid = min(max_mid, n)
    n_glob_all = glob.sum()
    padded = torch.cat([by_tier, torch.zeros(m_mid, dtype=torch.long, device=dev)])
    sel_mid = padded[n_glob_all + torch.arange(m_mid, device=dev)]
    mid_ok = torch.arange(m_mid, device=dev) < keep_mid.sum()
    tid_s, cov_s = _cover(m2, radius.clamp_max(R_SMALL), small, tw, th, SPAN_SMALL)
    tid_m, cov_m = _cover(m2[sel_mid], radius[sel_mid], mid_ok, tw, th, SPAN_MID)
    return dict(bits=bits, tier=tier, by_tier=by_tier, n_glob_all=n_glob_all,
                sel_mid=sel_mid, tid_s=tid_s, cov_s=cov_s, tid_m=tid_m, cov_m=cov_m)


def budgets(proj: dict, cam: Camera, bcfg: dict,
            dtype=torch.float32) -> tuple[np.ndarray, int]:
    """(each tile's candidate budget [T] int64, the global count joining
    every tile) for the scene ``proj`` (the render settings' budget), the
    transmittance bound summed in ``dtype``."""
    with torch.no_grad():
        tw, th = cam.width // TILE, cam.height // TILE
        n_tiles = tw * th
        n = proj["radius"].shape[0]
        dev = proj["radius"].device
        t = _tiers(proj, min(bcfg["max_mid"], n), tw, th)
        k_s, k_m = SPAN_SMALL * SPAN_SMALL, SPAN_MID * SPAN_MID
        tid = torch.cat([t["tid_s"].reshape(-1), t["tid_m"].reshape(-1)])
        counts = torch.bincount(tid.clamp(0, n_tiles), minlength=n_tiles + 1)[:n_tiles]
        alpha = proj["alpha"].detach()
        radius, sel_mid = proj["radius"], t["sel_mid"]

        def occlusion(rad, ncov):
            # the footprint integral 2 pi (rad / 3)^2 over the covered tiles
            return torch.clamp_max((2.0 * math.pi / 9.0) * rad * rad
                                   / (float(PIXELS) * ncov.clamp_min(1)), 1.0)

        a_s = alpha * occlusion(radius.clamp_max(R_SMALL), t["cov_s"])
        a_m = alpha[sel_mid] * occlusion(radius[sel_mid], t["cov_m"])
        a = torch.cat([a_s[:, None].expand(n, k_s).reshape(-1),
                       a_m[:, None].expand(-1, k_m).reshape(-1)]).to(dtype)
        bits = torch.cat([t["bits"][:, None].expand(n, k_s).reshape(-1),
                          t["bits"][sel_mid][:, None].expand(-1, k_m).reshape(-1)])
        order = _key_sort(tid, bits)
        s_tid, s_a = tid[order], a[order]
        real = s_tid < n_tiles
        lg = torch.where(real, torch.log1p(-GAMMA_COVER * s_a.clamp_max(0.99)), 0.0)
        before = torch.cumsum(lg, 0) - lg
        first = torch.searchsorted(s_tid, torch.arange(n_tiles, device=dev))
        base = before[first.clamp(0, s_tid.shape[0] - 1)]
        inside = before - base[s_tid.clamp(0, n_tiles - 1)]
        log_eps = torch.log(torch.tensor(T_EPS, dtype=dtype, device=dev))
        sat = torch.zeros(n_tiles + 1, dtype=torch.long, device=dev)
        sat.index_add_(0, s_tid.clamp(0, n_tiles), (real & (inside > log_eps)).long())
        counts, sat = counts.cpu().numpy(), sat[:n_tiles].cpu().numpy()
        n_big = int(t["n_glob_all"])
    g = 32
    while g < n_big and g < bcfg["glob_cap"]:
        g *= 2
    joined = min(n_big, min(g, n))
    need = np.minimum(counts + joined, 2 * sat + 32 + joined)
    need = np.minimum(np.maximum(need.astype(np.int64), 1), bcfg["cap"])
    budget = np.maximum(32, 1 << np.ceil(np.log2(need)).astype(np.int64))
    return np.minimum(np.minimum(budget, bcfg["cap"]), n), g


def windows(proj: dict, cam: Camera, max_global: int, max_mid: int):
    """(sorted tile id, splat id) of every tile's candidates, in each
    tile's (depth, tier, splat id) order."""
    with torch.no_grad():
        tw, th = cam.width // TILE, cam.height // TILE
        n_tiles = tw * th
        n = proj["radius"].shape[0]
        dev = proj["radius"].device
        t = _tiers(proj, min(max_mid, n), tw, th)
        n_glob = min(max_global, n)
        sel_g = t["by_tier"][:n_glob]
        glob_ok = t["tier"][sel_g] == 0
        sel_mid, bits = t["sel_mid"], t["bits"]
        k_s, k_m = SPAN_SMALL * SPAN_SMALL, SPAN_MID * SPAN_MID
        tid_g = torch.where(glob_ok[None, :], torch.arange(n_tiles, device=dev)[:, None],
                            n_tiles)
        tid = torch.cat([t["tid_s"].reshape(-1), t["tid_m"].reshape(-1), tid_g.reshape(-1)])
        dep = torch.cat([bits[:, None].expand(n, k_s).reshape(-1),
                         bits[sel_mid][:, None].expand(-1, k_m).reshape(-1),
                         bits[sel_g][None, :].expand(n_tiles, n_glob).reshape(-1)])
        ids = torch.cat([torch.arange(n, device=dev)[:, None].expand(n, k_s).reshape(-1),
                         sel_mid[:, None].expand(-1, k_m).reshape(-1),
                         sel_g[None, :].expand(n_tiles, n_glob).reshape(-1)])
        order = _key_sort(tid, dep)
        return tid[order], ids[order]


def tile_groups(s_tid, budget: np.ndarray, bm: int, max_pairs: int = 1 << 18):
    """[(tile ids, window ids [C, M], window valid [C, M], counts [C])]:
    tiles of one budget together, M the budget rounded up to ``bm``."""
    dev = s_tid.device
    n_tiles = budget.shape[0]
    start = torch.searchsorted(s_tid, torch.arange(n_tiles, device=dev))
    end = torch.searchsorted(s_tid, torch.arange(n_tiles, device=dev), right=True)
    groups = []
    for b in sorted(set(budget.tolist())):
        tiles = np.flatnonzero(budget == b)
        m = -(-b // bm) * bm
        step = max(1, max_pairs // m)
        for c in range(0, len(tiles), step):
            tt = torch.from_numpy(tiles[c:c + step]).to(dev)
            idx = start[tt, None] + torch.arange(m, device=dev)[None, :]
            ok = (idx < end[tt, None]) & (torch.arange(m, device=dev)[None, :] < b)
            cnt = torch.clamp(end[tt] - start[tt], max=b)
            groups.append((tt, idx.clamp(0, s_tid.shape[0] - 1), ok, cnt))
    return groups


# -------------------------------------------------------------- compositing


def composite(geo, al, counts, origin, bm: int, dtype=torch.float32, work=None):
    """rgb [C, 256, 3] (float32) of tiles whose candidates are ``geo``
    [C, M, 8] (mean, conic, color) and ``al`` [C, M] (0 on empty slots),
    front to back: each pixel's offsets from a candidate's mean in float32,
    the rest in ``dtype``.  ``work``, a dict, gains ``pairs`` (the
    (candidate, pixel) pairs with alpha >= 1/255 composited while the
    pixel's transmittance exceeds 1e-4) and ``rows`` (the candidates with
    at least one such pair)."""
    c_sz, m = al.shape
    dev = al.device
    al = al.to(dtype)
    px = torch.arange(TILE, dtype=torch.float32, device=dev) + 0.5
    gx = (origin[:, 0, None, None] + px[None, None, :]).expand(c_sz, TILE, TILE)
    gy = (origin[:, 1, None, None] + px[None, :, None]).expand(c_sz, TILE, TILE)
    gx, gy = gx.reshape(c_sz, 1, PIXELS), gy.reshape(c_sz, 1, PIXELS)
    rgb = torch.zeros(c_sz, PIXELS, 3, dtype=dtype, device=dev)
    trans = torch.ones(c_sz, PIXELS, dtype=dtype, device=dev)
    blocks = torch.clamp((counts.long() + bm - 1) // bm, max=m // bm)
    for b in range(int(blocks.max()) if c_sz else 0):
        act = (b < blocks) & (trans.amax(1) > T_EPS)
        if not bool(act.any()):
            break
        blk, ab = geo[:, b * bm:(b + 1) * bm], al[:, b * bm:(b + 1) * bm]
        dx = (gx - blk[:, :, 0:1]).to(dtype)
        dy = (gy - blk[:, :, 1:2]).to(dtype)
        blk = blk.to(dtype)
        power = -0.5 * (blk[:, :, 2:3] * dx * dx + 2.0 * blk[:, :, 3:4] * dx * dy
                        + blk[:, :, 4:5] * dy * dy)
        a = (ab[:, :, None] * torch.exp(power.clamp_max(0.0))).clamp_max(ALPHA_MAX)
        a = torch.where(a < ALPHA_MIN, 0.0, a)
        tb = torch.cumprod(1.0 - a, dim=1)
        t_before = trans[:, None, :] * torch.cat([torch.ones_like(tb[:, :1]), tb[:, :-1]], 1)
        new_rgb = rgb + torch.einsum("cmp,cmk->cpk", a * t_before, blk[:, :, 5:8])
        new_trans = trans * tb[:, -1, :]
        rgb = torch.where(act[:, None, None], new_rgb, rgb)
        trans = torch.where(act[:, None], new_trans, trans)
        if work is not None:
            live = (a > 0) & (t_before > T_EPS) & act[:, None, None]
            work["pairs"] = work.get("pairs", 0) + int(live.sum())
            work["rows"] = work.get("rows", 0) + int(live.any(2).sum())
    return rgb.to(torch.float32)


def _tiles_of(img, tw, th):
    return img.reshape(th, TILE, tw, TILE, 3).permute(0, 2, 1, 3, 4).reshape(-1, PIXELS, 3)


def _image_of(tiles, tw, th):
    return tiles.reshape(th, tw, TILE, TILE, 3).permute(0, 2, 1, 3, 4).reshape(
        th * TILE, tw * TILE, 3)


def _origins(tt, tw):
    return torch.stack([(tt % tw) * TILE, (tt // tw) * TILE], 1).to(torch.float32)


class Frame:
    """One camera's binning of one scene under one budget."""

    def __init__(self, proj: dict, cam: Camera, budget: np.ndarray, max_global: int,
                 rcfg: dict):
        s_tid, self.s_ids = windows(proj, cam, max_global, rcfg["budget"]["max_mid"])
        self.bm = int(rcfg["block_m"])
        self.groups = tile_groups(s_tid, budget, self.bm)
        self.tw, self.th = cam.width // TILE, cam.height // TILE

    def _gather(self, g, packed, alpha):
        tt, idx, ok, cnt = g
        ids = self.s_ids[idx]
        geo = packed[ids]
        al = torch.where(ok, alpha[ids], 0.0)
        return geo, al, cnt, _origins(tt, self.tw)

    def image(self, proj, dtype=torch.float32, work=None):
        """The frame [H, W, 3] with no gradient."""
        with torch.no_grad():
            packed = torch.cat([proj["means2d"], proj["conic"], proj["color"]], 1)
            alpha = proj["alpha"]
            tiles = torch.zeros(self.tw * self.th, PIXELS, 3, device=alpha.device)
            for g in self.groups:
                geo, al, cnt, org = self._gather(g, packed, alpha)
                tiles[g[0]] = composite(geo, al, cnt, org, self.bm, dtype, work)
        return _image_of(tiles, self.tw, self.th)

    def backward(self, proj, grad_img, dtype=torch.float32):
        """Accumulate d(loss)/d(parameters) through ``proj`` from the
        image's gradient, tile group by tile group."""
        packed = torch.cat([proj["means2d"], proj["conic"], proj["color"]], 1)
        alpha = proj["alpha"]
        p_leaf = packed.detach().requires_grad_(True)
        a_leaf = alpha.detach().requires_grad_(True)
        g_tiles = _tiles_of(grad_img, self.tw, self.th)
        for g in self.groups:
            geo, al, cnt, org = self._gather(g, p_leaf, a_leaf)
            rgb = composite(geo, al, cnt, org, self.bm, dtype)
            torch.autograd.backward(rgb, g_tiles[g[0]])
        torch.autograd.backward([packed, alpha], [p_leaf.grad, a_leaf.grad])


def render(p: dict, cam: Camera, budget, max_global, rcfg, dtype=torch.float32,
           work=None):
    """The frame of parameters ``p`` (no gradient); ``rcfg``: the render
    settings with the scene's ``sh_degree``."""
    with torch.no_grad():
        proj = project(p, cam, rcfg["sh_degree"])
        return Frame(proj, cam, budget, max_global, rcfg).image(proj, dtype, work)


def adam_steps(start: dict, target, cam: Camera, budget, max_global, rcfg, tcfg,
               steps: int, dtype=torch.float32, work=None, state=None):
    """``steps`` Adam steps on the mean squared pixel error from ``start``
    (the step of ``make_train_step``: Adam as PyTorch states it, then each
    quaternion renormalized), from fresh moments or from ``state`` (by
    leaf: ``exp_avg``, ``exp_avg_sq`` and the ``step`` count before it).
    Returns (losses, first-step gradients by leaf, parameters after the
    last step)."""
    lr, (b1, b2), eps = tcfg["lr"], tcfg["betas"], tcfg["eps"]
    p = {k: v.detach().clone() for k, v in start.items()}
    if state is None:
        state = {k: {"exp_avg": torch.zeros_like(v), "exp_avg_sq": torch.zeros_like(v),
                     "step": 0} for k, v in p.items()}
    m = {k: state[k]["exp_avg"].clone() for k in p}
    v2 = {k: state[k]["exp_avg_sq"].clone() for k in p}
    count = {k: int(state[k]["step"]) for k in p}
    losses, first = [], None
    for s in range(steps):
        leaves = {k: x.detach().requires_grad_(True) for k, x in p.items()}
        proj = project(leaves, cam, rcfg["sh_degree"])
        frame = Frame(proj, cam, budget, max_global, rcfg)
        img = frame.image(proj, dtype, work if s == 0 else None)
        img_leaf = img.requires_grad_(True)
        loss = torch.mean((img_leaf - target) ** 2)
        loss.backward()
        losses.append(float(loss.detach()))
        frame.backward(proj, img_leaf.grad, dtype)
        grads = {k: x.grad for k, x in leaves.items()}
        if first is None:
            first = {k: (torch.zeros_like(p[k]) if g is None else g.detach().clone())
                     for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                if g is None:
                    continue  # an unused leaf: Adam leaves it alone
                count[k] += 1
                t = count[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                denom = torch.sqrt(v2[k]) / math.sqrt(1 - b2 ** t) + eps
                p[k] = p[k] - (lr / (1 - b1 ** t)) * m[k] / denom
            p["quat"] = p["quat"] / torch.linalg.norm(p["quat"], dim=-1,
                                                      keepdim=True).clamp_min(1e-8)
        del leaves, proj, frame, img, img_leaf, loss
    return losses, first, p

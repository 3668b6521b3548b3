"""Statistical Outlier Removal (SOR): Morton-window mean-KNN distance filter.

Reference contract (processing/gpu_ops.py:99-263, data_processor.py:119-182):
mean distance to the K nearest neighbours (K capped at 50), keep points with
``mean_dist < mean + sigma * std``.  Intensity slider i in [1,10] maps to
K = int(10 + (i-1)*40/9), sigma = 20.0 - (i-1)*17/9 (data_processor.py:131-134).

Candidates are the contiguous +-``window`` rows around each point's block in
Morton-sorted order.  Missing neighbours (fewer than k valid candidates) are
filled at the largest found distance, so isolated flyers rank as outliers.
An ensemble of rotated and shifted Morton orders (``_PASS_ORDERS``) takes the
elementwise MIN of the per-pass mean-KNN distances.

Two routes compute one pass, chosen as the JAX package chooses them, by the
power-of-two bucket of N:
  - ``next_pow2(n) >= 4096``: the block-local bisection of kernel K1,
    ``csrc/sor_window.cu`` on a CUDA tensor (``_sor_window_loop_kernel``),
    its plain PyTorch version ``_sor_window_loop_ref`` on a CPU tensor.  N
    is padded to a multiple of the kernel's 512-point block.
  - smaller N: ``_sor_window_loop``, an exact top-k within the window.

Known divergence from the reference (documented upstream): its CPU fallback
computes the mask but never applies it; the mask is applied here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .padding import PAD_POS, next_pow2, pad_rows, round_up
from .quant import morton3_u32

MAX_K = 50  # reference gpu_ops.py:119,244
KERNEL_BLOCK = 512  # points per block of kernel K1
KERNEL_MIN_BUCKET = 4096  # next_pow2(n) from which K1 takes the pass
_D_VALID_MAX = 1e12  # pad sentinels sit at PAD_POS=1e15; real pairs are closer
_MORTON_INVALID = 0xFFFFFFFF

#: launches of kernel K1 by ``_sor_window_loop_kernel``
KERNEL_LAUNCHES = 0


def intensity_to_params(intensity: float) -> tuple[int, float]:
    """Slider mapping (reference data_processor.py:131-134)."""
    k = int(10 + (intensity - 1) * (40 / 9))
    factor = 20.0 - (intensity - 1) * (17.0 / 9)
    return k, factor


def resolve_window(k: int) -> int:
    """Candidate window ~8x the neighbour count, a power of two >= 128."""
    return max(128, next_pow2(8 * min(int(k), MAX_K)))


def _morton_key(pos: torch.Tensor, valid: torch.Tensor, rot, shift) -> torch.Tensor:
    """Space-filling key for one ensemble ordering (invalid rows sort last).

    ``rot`` rotates the frame the curve is built in (distances are rotation
    invariant, so only the order changes); ``shift`` translates the grid by
    shift*512 cells per axis, moving every octree split plane.  int64 keys
    holding the JAX package's uint32 values.
    """
    posr = pos if rot is None else pos @ torch.as_tensor(rot, device=pos.device).T
    mins = torch.where(valid[:, None], posr, PAD_POS).amin(dim=0)
    maxs = torch.where(valid[:, None], posr, -PAD_POS).amax(dim=0)
    rng = torch.where(maxs > mins, maxs - mins, 1.0)
    t = torch.clamp((posr - mins) / rng, 0.0, 1.0)
    shift_t = torch.tensor(shift, dtype=torch.float32, device=pos.device) * 512.0
    g = (t * 511.0 + shift_t).to(torch.int64)
    key = morton3_u32(g[:, 0], g[:, 1], g[:, 2])
    return torch.where(valid, key, _MORTON_INVALID)


def _euler_mat(a, b, c):
    ca, sa, cb, sb, cc, sc = (np.cos(a), np.sin(a), np.cos(b),
                              np.sin(b), np.cos(c), np.sin(c))
    rx = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rz = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)


# (rotation, grid shift) per ensemble pass: rotated frames and translated
# octree planes give near-independent neighbour-miss patterns
_PASS_ORDERS = (
    (None, (0.0, 0.0, 0.0)),
    (_euler_mat(0.6, 1.1, 0.3), (0.47, 0.23, 0.71)),
    (_euler_mat(2.1, 0.4, 1.7), (0.19, 0.83, 0.37)),
    (_euler_mat(1.0, 2.5, 0.8), (0.71, 0.41, 0.13)),
)


def _pad_window(spos: torch.Tensor, before: int, after: int) -> torch.Tensor:
    pad = lambda m: torch.full((m, 3), PAD_POS, dtype=spos.dtype, device=spos.device)
    return torch.cat([pad(before), spos, pad(after)], dim=0)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as the kernel's ``__fsqrt_rn``.

    torch's CPU f32 ``sqrt`` goes through a vector-math library that is an
    ulp off on about 0.7% of inputs, and less accurate still in some
    process states; the f64 root rounded to f32 is the exact f32 root.
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _sq_norm(a: torch.Tensor) -> torch.Tensor:
    """||a||^2 over the last axis of [..., 3] as the fused multiply-add chain
    fma(a2, a2, fma(a1, a1, a0 * a0)), each step rounded once to f32 (the
    products are exact in f64).  That is how XLA's CPU backend contracts the
    JAX loop's ``sum(x * x)``, and how the CPU matmul forms ``x @ c.T``."""
    a64 = a.to(torch.float64)
    acc = (a64[..., 0] * a64[..., 0]).to(torch.float32).to(torch.float64)
    acc = (a64[..., 1] * a64[..., 1] + acc).to(torch.float32).to(torch.float64)
    return (a64[..., 2] * a64[..., 2] + acc).to(torch.float32)


def _sor_window_loop(spos: torch.Tensor, svalid: torch.Tensor, k: int,
                     window: int, block: int, batch: int = 8) -> torch.Tensor:
    """Exact top-k mean-KNN within +-window of each block (small-N route).

    Same math as the JAX package's XLA window loop: squared distances by the
    ||x||^2 + ||c||^2 - 2 x.c expansion, rounded to bf16, self pairs excluded
    by index.  ``batch`` blocks are processed per step.
    """
    n = spos.shape[0]
    pad = (-n) % block
    cwidth = block + 2 * window
    posp = _pad_window(spos, window, window + pad)
    validp = torch.cat([svalid.new_zeros(window), svalid,
                        svalid.new_zeros(window + pad)])
    nb = (n + pad) // block
    cand_all = posp.unfold(0, cwidth, block).transpose(1, 2)  # [nb, cw, 3]
    cvalid_all = validp.unfold(0, cwidth, block)  # [nb, cw]
    ar = torch.arange(cwidth, device=spos.device)
    self_idx = (torch.arange(block, device=spos.device)[:, None] + window) == ar[None, :]
    out = []
    for b0 in range(0, nb, batch):
        cand = cand_all[b0:b0 + batch]
        cvalid = cvalid_all[b0:b0 + batch]
        x = cand[:, window:window + block]
        d2 = ((_sq_norm(x)[:, :, None] + _sq_norm(cand)[:, None, :])
              - 2.0 * (x @ cand.transpose(1, 2)))
        ok = cvalid[:, None, :] & ~self_idx & (d2 > 1e-12)
        d2 = torch.where(ok, torch.clamp(d2, min=0.0), torch.inf)
        d2 = d2.to(torch.bfloat16).to(torch.float32)
        dk2 = torch.topk(d2, k, dim=-1, largest=False).values
        found = torch.isfinite(dk2)
        dist = _sqrt_rn(torch.where(found, dk2, 0.0))
        cnt = found.sum(-1)
        fill = (k - cnt).to(torch.float32) * dist.amax(-1)
        out.append(((dist.sum(-1) + fill) / k).reshape(-1))
    return torch.cat(out)[:n]


def _check_kernel_args(spos: torch.Tensor, k: int, window: int, iters: int):
    if spos.dtype != torch.float32 or spos.dim() != 2 or spos.shape[1] != 3:
        raise ValueError(f"SOR kernel takes [n, 3] float32 positions, got "
                         f"{tuple(spos.shape)} {spos.dtype}")
    if not spos.is_contiguous():
        raise ValueError("SOR kernel takes contiguous positions")
    n = spos.shape[0]
    if n == 0 or n % KERNEL_BLOCK:
        raise ValueError(f"SOR kernel needs n to be a positive multiple of "
                         f"{KERNEL_BLOCK}, got {n}")
    if window <= 0 or KERNEL_BLOCK % window:
        raise ValueError(f"SOR kernel needs window to divide {KERNEL_BLOCK}, "
                         f"got {window}")
    if not 1 <= k <= MAX_K or iters < 0:
        raise ValueError(f"SOR kernel needs 1 <= k <= {MAX_K} and iters >= 0, "
                         f"got k={k}, iters={iters}")


def _sor_window_loop_ref(spos: torch.Tensor, k: int, window: int, iters: int,
                         max_elems: int = 1 << 26) -> torch.Tensor:
    """Plain PyTorch version of kernel K1: the same block-local bisection.

    Distances are computed as the kernel computes them and rounded to bf16,
    so both take identical bisection steps; sums differ only in order.
    ``max_elems`` bounds the [blocks, candidates, 512] temporaries per step.
    """
    _check_kernel_args(spos, k, window, iters)
    n = spos.shape[0]
    bsz = KERNEL_BLOCK
    cw = bsz + 2 * window
    nb = n // bsz
    cand_all = _pad_window(spos, window, window).unfold(0, cw, bsz)  # [nb, 3, cw]
    x_all = spos.view(nb, bsz, 3)
    kf = torch.tensor(float(k), device=spos.device)
    batch = max(1, max_elems // (cw * bsz))
    out = []
    for b0 in range(0, nb, batch):
        cand = cand_all[b0:b0 + batch]
        x = x_all[b0:b0 + batch]
        acc = None
        for a in range(3):
            t = cand[:, a, :, None] - x[:, None, :, a]  # [b, cw, 512]
            acc = t * t if acc is None else acc + t * t
        d = _sqrt_rn(acc)
        del acc
        v = torch.where((d > 1e-6) & (d < _D_VALID_MAX), d, torch.inf)
        v = v.to(torch.bfloat16).to(torch.float32)
        del d
        fin = v < _D_VALID_MAX
        dz = torch.where(fin, v, 0.0)
        cntv = fin.sum(1)
        sumv = dz.sum(1)
        dmax = dz.amax(1)
        cntm = fin[:, window:window + bsz].sum(1)
        hmid = dz[:, window:window + bsz].amax(1)
        del fin, dz
        hi = torch.where(cntm >= k, hmid, dmax)
        lo = torch.zeros_like(hi)
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            pred = (v <= mid[:, None, :]).sum(1) >= k
            lo = torch.where(pred, lo, mid)
            hi = torch.where(pred, mid, hi)
        sel = v <= lo[:, None, :]
        cl = sel.sum(1).to(torch.float32)
        sl = torch.where(sel, v, 0.0).sum(1)
        mdk = (sl + (kf - cl) * 0.5 * (lo + hi)) / kf
        mdf = (sumv + (kf - cntv.to(torch.float32)) * dmax) / kf
        out.append(torch.where(cntv >= k, mdk, mdf).reshape(-1))
    return torch.cat(out)


def _sor_window_loop_kernel(spos: torch.Tensor, k: int, window: int,
                            iters: int) -> torch.Tensor:
    """Mean-KNN distance per Morton-sorted point by kernel K1.

    ``spos`` is [n, 3] float32, n a multiple of 512, pad rows at PAD_POS.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises); any other device raises.
    """
    global KERNEL_LAUNCHES
    _check_kernel_args(spos, k, window, iters)
    if spos.device.type == "cpu":
        return _sor_window_loop_ref(spos, k, window, iters)
    if spos.device.type != "cuda":
        raise ValueError(f"SOR kernel runs on CUDA or CPU tensors, got {spos.device}")
    launch = _kernel_fn()
    md = torch.empty(spos.shape[0], dtype=torch.float32, device=spos.device)
    with torch.cuda.device(spos.device):
        stream = torch.cuda.current_stream(spos.device).cuda_stream
        err = launch(spos.data_ptr(), md.data_ptr(), spos.shape[0],
                     int(k), int(window), int(iters), stream)
    if err != 0:
        raise RuntimeError(f"sor_window_md launch failed with CUDA error {err}")
    KERNEL_LAUNCHES += 1
    return md


def _kernel_fn():
    """``sor_window_md`` of the built ``csrc/sor_window.cu``, typed for ctypes."""
    from ..utils import cuda_build

    fn = cuda_build.load("sor_window").sor_window_md
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sor_md_window(pos: torch.Tensor, valid: torch.Tensor, k: int, window: int,
                   passes: int, iters: int, use_kernel: bool,
                   block: int = 1024) -> torch.Tensor:
    """Ensemble-MIN mean-KNN distance over ``passes`` Morton orders.

    Each pass re-sorts (positions, original index, running md) by the next
    order's key; one scatter at the end restores the caller's order.
    Invalid rows are moved to PAD_POS so validity survives the sorts.
    """
    n = pos.shape[0]
    cpos = torch.where(valid[:, None], pos, PAD_POS)
    cidx = torch.arange(n, device=pos.device)
    cmd = torch.full((n,), torch.inf, dtype=torch.float32, device=pos.device)
    for rot, shift in _PASS_ORDERS[:max(1, passes)]:
        cvalid = cpos[:, 0] < _D_VALID_MAX
        key = _morton_key(cpos, cvalid, rot, shift)
        order = torch.sort(key, stable=True).indices
        cpos, cidx, cmd = cpos[order], cidx[order], cmd[order]
        if use_kernel:
            md_sorted = _sor_window_loop_kernel(cpos, k, window, iters)
        else:
            md_sorted = _sor_window_loop(cpos, cpos[:, 0] < _D_VALID_MAX, k,
                                         window, min(block, n))
        cmd = torch.minimum(cmd, md_sorted)
    md = torch.empty_like(cmd)
    md[cidx] = cmd
    return md


def _sor_mask_stats(md: torch.Tensor, valid: torch.Tensor, n_valid: int,
                    sigma: float) -> torch.Tensor:
    cnt = torch.tensor(float(n_valid), device=md.device)
    sig = torch.tensor(float(sigma), device=md.device)
    mean = torch.where(valid, md, 0.0).sum() / cnt
    var = torch.where(valid, (md - mean) ** 2, 0.0).sum() / cnt
    thresh = mean + sig * _sqrt_rn(torch.clamp(var, min=0.0))
    return (md < thresh) & valid


def sor_mask(pos: torch.Tensor, k: int, sigma: float, method: str = "window",
             passes: int | None = None, window: int | None = None,
             iters: int | None = None) -> torch.Tensor:
    """Keep-mask: mean_knn_dist < mean + sigma * std (reference gpu_ops.py:259-263).

    ``pos`` is an [N, 3] tensor; the mask comes back on its device.  Settings
    by sigma, as in the JAX package: sigma >= 3 (the slider's range) takes 1
    pass, a k-scaled window and 7 bisection steps; tighter sigmas take 2
    passes, a window of at least 512 and 10 steps.
    """
    if method != "window":
        raise NotImplementedError(
            f"SOR method={method!r} is not ported yet (ROADMAP queue 1, "
            "SOR method='grid'); use method='window'")
    fast = float(sigma) >= 3.0
    if passes is None:
        passes = 1 if fast else 2
    if window is None:
        window = resolve_window(k) if fast else max(512, resolve_window(k))
    if iters is None:
        iters = 7 if fast else 10
    if window <= 0:
        raise ValueError(f"sor_mask: window must be positive, got {window}")
    k = min(int(k), MAX_K)
    n = pos.shape[0]
    use_kernel = (next_pow2(n) >= KERNEL_MIN_BUCKET
                  and KERNEL_BLOCK % window == 0)
    p = round_up(n, KERNEL_BLOCK) if use_kernel else next_pow2(n)
    posp = pad_rows(pos.to(torch.float32), p, PAD_POS).contiguous()
    valid = torch.arange(p, device=pos.device) < n
    md = _sor_md_window(posp, valid, k, window, passes, iters, use_kernel)
    return _sor_mask_stats(md, valid, n, sigma)[:n]

"""K-Means: k-means++ init, Lloyd steps, chunked palettes, assign, update.

The JAX package's ``ops/kmeans.py`` on three Pallas TPU kernels, here on
hand-written CUDA kernels, K2's labels and K3 in ``csrc/kmeans.cu`` and K4
in ``csrc/kmeans_update.cu``:

  - K2, the Lloyd step (labels, segment sums and counts), batched over
    independent chunks: ``_lloyd_kernel``, two stages.  The labels kernel
    forms them in bf16 mode on the tensor cores (``mma.sync``) and
    re-checks exactly, by the FMA chain, every row below n_valid whose two
    nearest centroids lie within ``_nearest``'s error bound of each other;
    in f32 mode it runs the FMA chain on the CUDA cores.  It also writes
    each row's segment (chunk * K + label, -1 at and above n_valid), and
    K4 sums the segments: so the sums are in ``_lloyd_ordered_ref``'s
    order, the same on every card;
  - K3, nearest-centroid labels for any K: ``_assign_kernel``.  Up to
    D = 128 it splits the f32 values into two bf16 terms each, forms x.c
    as one three-term tensor-core product, and re-checks exactly, by the
    FMA chain of the f32 values, every row whose two nearest centroids lie
    within that product's error bound of each other (``_assign_split_ref``
    is this route in plain PyTorch); wider rows take the FMA chain on the
    CUDA cores;
  - K4, segment sums and counts of labelled rows, in a summation order
    fixed by the input alone (``_update_ordered_ref``): ``_update_kernel``.

Each wrapper launches its kernels on a CUDA tensor and takes its plain
PyTorch version (``_lloyd_ref``, ``_assign_ref``, ``_update_ref``) on a CPU
tensor.  The kernels take any K and rows of D <= 2048 values; a wider CUDA
tensor raises.  Routes, as the JAX package's ``_resolve_impl`` picks them:

  ============  ======================================  ==================
  function      CUDA tensor                             CPU tensor
  ============  ======================================  ==================
  lloyd_step    K2 at ``precision`` if k <= 2048 and     f32 blocked path
                D <= 128, else K2 at f32
  assign        K3                                      f32 blocked path
  update        K4                                      segment sums
  ============  ======================================  ==================

The f32 blocked paths are the plain versions at f32, the counterparts of
JAX's ``_lloyd_xla`` and ``_assign_xla``; the CPU route ignores
``precision``, as JAX's does, and so does K2 beyond the JAX package's
bf16 kernel range (its wider problems take the f32 XLA route).
``precision="bf16"`` (the default) rounds x and the centroids to bf16 for
the distance product and sums the rounded x, as K2 does on the TPU's
matrix unit.

Fixed iteration counts, no convergence check; empty clusters keep their
previous centroid (the JAX package's divergence from the reference, which
zeroes them).  Under a mesh of more than one rank (``parallel.mesh``),
``kmeans`` and ``kmeans_chunked`` take the sharded paths of
``parallel/distributed.py`` when the padded rows (and chunks) split evenly
over the ranks (``_dispatch_mesh``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import resolve_device
from ..utils.log import span
from .padding import PAD_POS, next_pow2, pad_rows

MAX_D = 2048  # widest rows the kernels take (csrc/kmeans.cu kMaxD)
# ``precision`` holds up to these; beyond them K2 runs in f32, as the JAX
# package's Lloyd step leaves its bf16 kernel for the f32 XLA route
PRECISION_MAX_K, PRECISION_MAX_D = 2048, 128
UPDATE_PIECE = 256  # rows per piece of K4's summation order (csrc/kmeans_update.cu kPiece)
_REF_ELEMS = 1 << 25  # bound on the plain versions' [C, rows, K] temporaries
# k-means++ candidate pool when n_valid is given (JAX kmeans.py:381)
_INIT_SUBSAMPLE = 65536

#: launches of each kernel by its wrapper: K2 "lloyd", K3 "assign", K4 "update"
#: (K2's sum stage also counts under "update")
LAUNCHES = {"lloyd": 0, "assign": 0, "update": 0}
#: rows of each chunk [C] (int32, on the card) that the last K2 launch
#: re-checked by the exact FMA chain
LAST_RECHECKED: torch.Tensor | None = None
#: rows [1] (int32, on the card) that the last K3 launch re-checked by the
#: exact FMA chain
LAST_ASSIGN_RECHECKED: torch.Tensor | None = None


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _check_precision(precision: str) -> None:
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got {precision!r}")


def _check_f32(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.float32 or t.dim() != ndim:
        raise ValueError(f"K-Means kernel takes {ndim}-D float32 {name}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"K-Means kernel takes contiguous {name}")


def _check_device(*ts: torch.Tensor) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("K-Means kernel inputs lie on different devices")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"K-Means kernels run on CUDA or CPU tensors, got {dev}")
    return dev.type


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _lib_fn(name: str, argtypes, source: str = "kmeans"):
    """``name`` of the built ``csrc/<source>.cu``, typed for ctypes."""
    from ..utils import cuda_build

    fn = getattr(cuda_build.load(source), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int

# ------------------------------------------------- distances of the plain versions
#
# The kernels (and XLA's CPU dot, which the JAX package's CPU route runs)
# form x.c as a sequential f32 fused multiply-add chain over d = 0, 1, ...,
# and ||c||^2 the same way.  Inputs on a u8 grid, as SOG's are, put many
# rows at exactly equal distance from two centroids, where the winner
# depends on those roundings.  The plain versions therefore take a fast
# matmul for every row and recompute the chain exactly (each step in f64,
# rounded once to f32) for the rows whose nearest centroid the matmul's
# rounding could have changed.


def _chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., R, D] . b [..., K, D] -> [..., R, K] by the FMA chain."""
    a64, b64 = a.to(torch.float64), b.to(torch.float64)
    acc = None
    for d in range(a.shape[-1]):
        prod = a64[..., :, d, None] * b64[..., None, :, d]
        acc = prod.to(torch.float32) if acc is None else (prod + acc).to(torch.float32)
        acc = acc.to(torch.float64)
    return acc.to(torch.float32)


def _sq_chain(c: torch.Tensor) -> torch.Tensor:
    """||c||^2 over the last axis of [..., K, D] by the FMA chain."""
    return _chain(c[..., :, None, :], c[..., :, None, :])[..., 0, 0] \
        if c.shape[-1] else c.new_zeros(c.shape[:-1])


def _nearest(x: torch.Tensor, c: torch.Tensor, c2: torch.Tensor,
             exact_rows: torch.Tensor | None = None) -> torch.Tensor:
    """First argmin over K of c2 - 2 x.c for x [C, R, D], c [C, K, D] and
    c2 [C, K], with x.c as the kernels form it.  ``exact_rows`` [C, R]
    limits the exact recompute to those rows (the others keep the
    matmul's winner)."""
    dist = c2[:, None, :] - 2.0 * torch.bmm(x, c.transpose(1, 2))
    lab = torch.argmin(dist, dim=2)
    # |matmul - chain| <= 2 gamma_D ||x|| ||c|| for any summation order;
    # twice that, plus the final subtraction's roundings
    g = 4.0 * x.shape[-1] * 2.0 ** -24
    err = (4.0 * g * torch.sqrt((x * x).sum(-1))[:, :, None]
           * torch.sqrt((c * c).sum(-1))[:, None, :] + 2.0 ** -21 * dist.abs())
    cand = (dist - err) <= (dist + err).amin(dim=2, keepdim=True)
    amb = cand.sum(dim=2) > 1
    if exact_rows is not None:
        amb &= exact_rows
    for ch in torch.nonzero(amb.any(dim=1)).flatten().tolist():
        rows = torch.nonzero(amb[ch]).flatten()
        for i in range(0, rows.numel(), 4096):
            r = rows[i:i + 4096]
            exact = c2[ch][None, :] - 2.0 * _chain(x[ch, r], c[ch])
            lab[ch, r] = torch.argmin(exact, dim=1)
    return lab

# ------------------------------------------------------- K2: fused Lloyd step


def _lloyd_ref(x: torch.Tensor, c: torch.Tensor, n_valid: torch.Tensor,
               precision: str = "bf16", block_chunks: int | None = None):
    """Plain PyTorch version of kernel K2, blocked over rows.

    x [C, P, D], c [C, K, D] f32, n_valid [C] -> (sums [C, K, D] f32,
    counts [C, K] f32, labels [C, P] int32).  Distances ||c||^2 - 2 x.c with
    ||c||^2 from the f32 centroids; in bf16 mode x and c are rounded to bf16
    first and the sums add up the rounded x.  Labels are the first argmin
    for every row, with the kernel's roundings on rows < n_valid (see
    ``_nearest``); only those rows enter the sums and counts.  Rows are
    blocked as for ``block_chunks`` chunks (default C), so a chunk's sums
    do not depend on how many chunks share the call.
    """
    _check_precision(precision)
    cc, p, d = x.shape
    k = c.shape[1]
    c2 = _sq_chain(c)
    if precision == "bf16":
        x, c = _bf16(x), _bf16(c)
    nv = n_valid.to(x.device).reshape(cc, 1)
    ks = torch.arange(k, device=x.device)
    bn = max(1, min(p, _REF_ELEMS // max(1, (block_chunks or cc) * k)))
    sums = x.new_zeros((cc, k, d))
    counts = x.new_zeros((cc, k))
    labels = []
    for r0 in range(0, p, bn):
        xb = x[:, r0:r0 + bn]
        rows = torch.arange(r0, r0 + xb.shape[1], device=x.device)
        real = rows[None, :] < nv
        lab = _nearest(xb, c, c2, exact_rows=real)
        onehot = ((lab[:, :, None] == ks) & real[:, :, None]).to(torch.float32)
        sums += torch.bmm(onehot.transpose(1, 2), xb)
        counts += onehot.sum(1)
        labels.append(lab.to(torch.int32))
    return sums, counts, torch.cat(labels, dim=1)


def _lloyd_ordered_ref(x: torch.Tensor, c: torch.Tensor, n_valid: torch.Tensor,
                       precision: str = "bf16"):
    """K2's function with K2's summation order, in plain PyTorch (for tests
    and the card's bit-for-bit check).

    The labels are ``_lloyd_ref``'s; the sums and counts are
    ``_update_ordered_ref`` (K4's order) of the rows below n_valid, in f32
    or bf16-rounded as ``precision`` says, with chunk * K + label as each
    row's segment.
    """
    _, _, labels = _lloyd_ref(x, c, n_valid, precision)
    cc, p, d = x.shape
    k = c.shape[1]
    xs = _bf16(x) if precision == "bf16" else x
    real = torch.arange(p, device=x.device)[None, :] < n_valid.to(x.device).reshape(cc, 1)
    base = (torch.arange(cc, device=x.device, dtype=torch.int32) * k)[:, None]
    seg = torch.where(real, labels + base, -1).to(torch.int32).reshape(-1)
    sums, counts = _update_ordered_ref(xs.reshape(cc * p, d), seg, cc * k)
    return sums.view(cc, k, d), counts.view(cc, k), labels


def _lloyd_kernel(x: torch.Tensor, c: torch.Tensor, n_valid: torch.Tensor,
                  precision: str = "bf16", rounded: bool = False):
    """One Lloyd step of every chunk by kernel K2 (``_lloyd_ref``'s function,
    with the sums in ``_lloyd_ordered_ref``'s order).

    A CPU tensor takes the plain version; a CUDA tensor launches K2's labels
    kernel (``kmeans_lloyd_labels``), then K4 (``_update_kernel``) on its
    segments as the sum stage (or raises).  ``rounded`` says that x already
    holds bf16-rounded values, so bf16 mode skips its rounding pass.  Any
    K, D <= MAX_D.
    """
    _check_precision(precision)
    _check_f32("x", x, 3)
    _check_f32("centroids", c, 3)
    cc, p, d = x.shape
    k = c.shape[1]
    if c.shape[0] != cc or c.shape[2] != d or k < 1 or p < 1:
        raise ValueError(f"K2 takes x [C, P, D] and centroids [C, K, D], got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if n_valid.dtype != torch.int32 or tuple(n_valid.shape) != (cc,) \
            or not n_valid.is_contiguous():
        raise ValueError(f"K2 takes n_valid as contiguous int32 [{cc}], got "
                         f"{tuple(n_valid.shape)} {n_valid.dtype}")
    if _check_device(x, c, n_valid) == "cpu":
        return _lloyd_ref(x, c, n_valid, precision)
    if d > MAX_D:
        raise ValueError(f"K2 takes D <= {MAX_D}, got {d}")
    bf16 = precision == "bf16"
    labels = torch.empty((cc, p), dtype=torch.int32, device=x.device)
    seg = torch.empty(cc * p, dtype=torch.int32, device=x.device)
    scratch = torch.empty(3 * cc * p, dtype=torch.int32, device=x.device)
    amb_count = torch.empty(cc, dtype=torch.int32, device=x.device)
    fn = _lib_fn("kmeans_lloyd_labels", [_P] * 7 + [_I] * 5 + [_P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), c.data_ptr(), n_valid.data_ptr(), labels.data_ptr(),
                 seg.data_ptr(), scratch.data_ptr(), amb_count.data_ptr(), cc, p, d, k,
                 int(bf16), _stream(x))
    _raise_on(err, "kmeans_lloyd_labels (K2)")
    LAUNCHES["lloyd"] += 1
    global LAST_RECHECKED
    LAST_RECHECKED = amb_count
    xs = _bf16(x) if bf16 and not rounded else x
    sums, counts = _update_kernel(xs.view(cc * p, d), seg, cc * k)
    return sums.view(cc, k, d), counts.view(cc, k), labels


def _lloyd_precision(x: torch.Tensor, c: torch.Tensor, precision: str) -> str:
    """K2's mode for x [C, P, D] and c [C, K, D]: f32 beyond the bf16 range."""
    if c.shape[1] > PRECISION_MAX_K or x.shape[2] > PRECISION_MAX_D:
        return "f32"
    return precision


def _lloyd(x: torch.Tensor, c: torch.Tensor, n_valid: torch.Tensor, precision: str,
           rounded: bool = False, block_chunks: int | None = None):
    """Route one batched Lloyd step (see the module's table)."""
    if x.device.type == "cpu":
        return _lloyd_ref(x, c, n_valid, "f32", block_chunks)
    return _lloyd_kernel(x.contiguous(), c.contiguous(), n_valid,
                         _lloyd_precision(x, c, precision), rounded)


def _n_valid(n_valid, device) -> torch.Tensor:
    """An int or one-element tensor as K2's int32 [1] ``n_valid``."""
    return torch.as_tensor(n_valid, dtype=torch.int32).to(device).reshape(1)


def lloyd_step(x: torch.Tensor, c: torch.Tensor, k: int, n_valid=None,
               precision: str = "bf16"):
    """One fused Lloyd iteration: (sums [k, D], counts [k], labels [N]).

    Rows >= ``n_valid`` get labels but stay out of the sums and counts.
    Callers divide: ``new_c = where(counts > 0, sums / max(counts, 1), prev_c)``.
    """
    _check_precision(precision)
    if c.shape[0] != k:
        raise ValueError(f"lloyd_step: {c.shape[0]} centroids for k={k}")
    nv = _n_valid(x.shape[0] if n_valid is None else n_valid, x.device)
    sums, counts, labels = _lloyd(x[None], c[None], nv, precision)
    return sums[0], counts[0], labels[0]


# ------------------------------------------------------------- K3: assign


def _assign_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K3: first argmin of ||c||^2 - 2 x.c,
    in f32 with the kernel's roundings (``_nearest``), blocked over rows.
    x [N, D], c [K, D] -> labels [N] int32."""
    c2 = _sq_chain(c)[None]
    bn = max(1, min(x.shape[0], _REF_ELEMS // max(1, c.shape[0])))
    return torch.cat([_nearest(x[None, i:i + bn], c[None], c2)[0].to(torch.int32)
                      for i in range(0, x.shape[0], bn)])


# K3's tensor-core route at D <= 128 (csrc/kmeans.cu, whose top comment
# derives the bound): x.c as xh.ch + xh.cl + xl.ch over the bf16 split of
# the f32 values, and the exact chain for every row in doubt.
_SPLIT_SLACK = 1.0625  # csrc/kmeans.cu kBoundSlack


def _split_bf16(t: torch.Tensor):
    """(hi, lo) with hi = bf16(t) and lo = bf16(t - hi), as f32."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def _split_norms(x: torch.Tensor, c: torch.Tensor):
    """||x|| per row (f64 sum of squares, rounded up to f32) and the
    largest ||c|| (f64), as K3 forms them."""
    xn64 = torch.sqrt((x.to(torch.float64) ** 2).sum(-1))
    xn = xn64.to(torch.float32)
    xn = torch.where(xn.to(torch.float64) < xn64, torch.nextafter(xn, xn.new_tensor(np.inf)), xn)
    cmax = torch.sqrt((c.to(torch.float64) ** 2).sum(-1).max())
    return xn.to(torch.float64), cmax


def _split_bound(xn: torch.Tensor, cmax: torch.Tensor, d: int,
                 dmax: torch.Tensor | None = None) -> torch.Tensor:
    """K3's bound E [rows] (f64) on |split-product d - FMA-chain d| of every
    centroid, from ||x|| [rows], max ||c|| and max(|d1|, |d2|) (left out
    when ``dmax`` is None: then E / 2 bounds the dot products alone)."""
    dp3 = -(-3 * d // 16) * 16  # the split product's contraction, padded
    rel = 2.0 * (1.03 * 4.0 * dp3 * 2.0 ** -24 + 3.1 * 2.0 ** -16 + d * 2.0 ** -23)
    e = rel * xn * cmax + 2.0 ** -123 * (d ** 0.5 * (xn + cmax) + dp3)
    if dmax is not None:
        e = e + 2.0 ** -21 * dmax
    return _SPLIT_SLACK * e


def _split_product(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """xh.ch + xh.cl + xl.ch [R, K] in f64 (each bf16 product is exact)."""
    (xh, xl), (ch, cl) = _split_bf16(x), _split_bf16(c)
    xh, xl, ch, cl = (t.to(torch.float64) for t in (xh, xl, ch, cl))
    return xh @ ch.T + xh @ cl.T + xl @ ch.T


def _assign_split_ref(x: torch.Tensor, c: torch.Tensor):
    """K3's tensor-core route in plain PyTorch, for tests and the card's
    check (nothing on the main path calls it): labels [N] int32 and the
    count of rows it re-checks exactly.

    d = c2 - 2 x.c with x.c the split product (here in f64, rounded once
    to f32 with d); the first argmin and the next distance d2 of each row;
    a row (K > 1) whose gap d2 - d1 is within 2E (``_split_bound``), or
    with a non-finite distance, or with ||x|| max||c|| >= 2^125, takes the
    FMA chain's label instead.  The labels are ``_assign_ref``'s.
    """
    n, d = x.shape
    k = c.shape[0]
    c2 = _sq_chain(c)
    xn, cmax = _split_norms(x, c)
    bn = max(1, min(n, _REF_ELEMS // max(1, k)))
    labels, listed = [], 0
    for i in range(0, n, bn):
        xb = x[i:i + bn]
        dist = (c2.to(torch.float64)[None, :] - 2.0 * _split_product(xb, c)).to(torch.float32)
        lab = torch.argmin(torch.where(torch.isnan(dist), np.inf, dist), dim=1)
        if k > 1:
            top = torch.topk(torch.where(torch.isnan(dist), np.inf, dist), 2, dim=1,
                             largest=False).values
            d1, d2 = top[:, 0].to(torch.float64), top[:, 1].to(torch.float64)
            e = _split_bound(xn[i:i + bn], cmax, d, torch.maximum(d1.abs(), d2.abs()))
            amb = (~((d2 - d1) > 2.0 * e) | ~torch.isfinite(d1) | ~torch.isfinite(d2)
                   | torch.isnan(dist).any(dim=1) | ~(xn[i:i + bn] * cmax < 2.0 ** 125))
            rows = torch.nonzero(amb).flatten()
            listed += int(rows.numel())
            for j in range(0, rows.numel(), 4096):
                r = rows[j:j + 4096]
                exact = c2[None, :] - 2.0 * _chain(xb[r], c)
                lab[r] = torch.argmin(exact, dim=1)
        labels.append(lab.to(torch.int32))
    return torch.cat(labels), listed


def _assign_kernel(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid labels by kernel K3 (``_assign_ref``'s function), for
    any K and D <= MAX_D.  A CPU tensor takes the plain version."""
    _check_f32("x", x, 2)
    _check_f32("centroids", c, 2)
    if c.shape[1] != x.shape[1] or x.shape[0] < 1 or c.shape[0] < 1:
        raise ValueError(f"K3 takes x [N, D] and centroids [K, D], got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if _check_device(x, c) == "cpu":
        return _assign_ref(x, c)
    if x.shape[1] > MAX_D:
        raise ValueError(f"K3 takes D <= {MAX_D}, got {x.shape[1]}")
    n, d = x.shape
    k = c.shape[0]
    words = ctypes.c_longlong(0)
    size_fn = _lib_fn("kmeans_assign_scratch", [_I] * 3 + [ctypes.POINTER(ctypes.c_longlong)])
    _raise_on(size_fn(n, d, k, ctypes.byref(words)), "kmeans_assign_scratch (K3)")
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    scratch = torch.empty(words.value, dtype=torch.int32, device=x.device)
    amb_count = torch.empty(1, dtype=torch.int32, device=x.device)
    fn = _lib_fn("kmeans_assign", [_P] * 5 + [_I] * 3 + [_P])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), c.data_ptr(), labels.data_ptr(), scratch.data_ptr(),
                 amb_count.data_ptr(), n, d, k, _stream(x))
    _raise_on(err, "kmeans_assign (K3)")
    LAUNCHES["assign"] += 1
    global LAST_ASSIGN_RECHECKED
    LAST_ASSIGN_RECHECKED = amb_count
    return labels


def assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid labels [N] int32 for points [N, D], centroids [K, D]."""
    return _assign_kernel(x.to(torch.float32).contiguous(),
                          c.to(torch.float32).contiguous())


# ------------------------------------------------------------- K4: update


def _update_ref(x: torch.Tensor, labels: torch.Tensor, k: int):
    """Plain PyTorch version of kernel K4: per-cluster sums [k, D] and counts
    [k] as blocked one-hot matmuls; labels outside [0, k) are dropped."""
    ks = torch.arange(k, device=x.device)
    bn = max(1, min(x.shape[0], _REF_ELEMS // max(1, k)))
    sums = x.new_zeros((k, x.shape[1]))
    counts = x.new_zeros(k)
    for i in range(0, x.shape[0], bn):
        onehot = (labels[i:i + bn, None] == ks).to(torch.float32)
        sums += onehot.T @ x[i:i + bn]
        counts += onehot.sum(0)
    return sums, counts


def _update_ordered_ref(x: torch.Tensor, labels: torch.Tensor, k: int):
    """K4's function in K4's summation order, in plain PyTorch (for tests
    and the card's bit-for-bit check; the CPU route takes ``_segment_sums``).

    The rows of cluster j in ascending row index, cut into pieces of
    UPDATE_PIECE rows from its first row; each piece summed left to right
    in f32 from +0.0; the piece sums of a cluster added in piece order from
    +0.0; counts exact.  Labels outside [0, k) are dropped.  Missing rows of
    short pieces add nothing: a sum from +0.0 is never -0.0, so skipping a
    row and adding +0.0 agree.
    """
    size = UPDATE_PIECE
    dev = x.device
    lab = torch.where((labels >= 0) & (labels < k), labels.to(torch.int64), k)
    perm = torch.sort(lab, stable=True).indices  # rows by (label, row)
    n_j = torch.bincount(lab, minlength=k + 1)[:k]
    start = torch.cumsum(n_j, 0) - n_j
    npc = (n_j + size - 1) // size  # pieces of each cluster
    poff = torch.cumsum(npc, 0) - npc
    owner = torch.repeat_interleave(torch.arange(k, device=dev), npc)
    q = torch.arange(owner.numel(), device=dev) - poff[owner]
    pstart = start[owner] + q * size
    plen = torch.clamp(n_j[owner] - q * size, max=size)
    pieces = x.new_zeros((owner.numel(), x.shape[1]))
    for o in range(size):  # vectorised over pieces, sequential within one
        live = torch.nonzero(plen > o).flatten()
        if live.numel() == 0:
            break
        pieces[live] = pieces[live] + x[perm[pstart[live] + o]]
    sums = x.new_zeros((k, x.shape[1]))
    for m in range(int(npc.max())):
        live = torch.nonzero(npc > m).flatten()
        sums[live] = sums[live] + pieces[poff[live] + m]
    return sums, n_j.to(torch.float32)


def _update_kernel(x: torch.Tensor, labels: torch.Tensor, k: int):
    """Segment sums and counts by kernel K4 (``_update_ref``'s function, in
    ``_update_ordered_ref``'s order), D <= MAX_D.  A CPU tensor takes the
    plain version."""
    _check_f32("x", x, 2)
    if labels.dtype != torch.int32 or tuple(labels.shape) != (x.shape[0],) \
            or not labels.is_contiguous():
        raise ValueError(f"K4 takes labels as contiguous int32 [{x.shape[0]}], "
                         f"got {tuple(labels.shape)} {labels.dtype}")
    if k < 1 or x.shape[0] < 1:
        raise ValueError(f"K4 takes k >= 1 and N >= 1, got k={k}, N={x.shape[0]}")
    if _check_device(x, labels) == "cpu":
        return _update_ref(x, labels, k)
    n, d = x.shape
    if d > MAX_D:
        raise ValueError(f"K4 takes D <= {MAX_D}, got {d}")
    ints, floats = ctypes.c_longlong(0), ctypes.c_longlong(0)
    size_fn = _lib_fn("kmeans_update_scratch",
                      [_I] * 3 + [ctypes.POINTER(ctypes.c_longlong)] * 2, "kmeans_update")
    _raise_on(size_fn(n, d, k, ctypes.byref(ints), ctypes.byref(floats)),
              "kmeans_update_scratch (K4)")
    sums = torch.empty((k, d), dtype=torch.float32, device=x.device)
    counts = torch.empty(k, dtype=torch.float32, device=x.device)
    iscratch = torch.empty(ints.value, dtype=torch.int32, device=x.device)
    fscratch = torch.empty(floats.value, dtype=torch.float32, device=x.device)
    fn = _lib_fn("kmeans_update", [_P] * 6 + [_I] * 3 + [_P], "kmeans_update")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), labels.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                 iscratch.data_ptr(), fscratch.data_ptr(), n, d, k, _stream(x))
    _raise_on(err, "kmeans_update (K4)")
    LAUNCHES["update"] += 1
    return sums, counts


def _segment_sums(x: torch.Tensor, labels: torch.Tensor, k: int):
    """Sums and counts by ``index_add_`` into k + 1 bins, the last one the
    discard bin of labels outside [0, k) (JAX's segment_sum route)."""
    lab = torch.where((labels >= 0) & (labels < k), labels.to(torch.int64), k)
    sums = x.new_zeros((k + 1, x.shape[1])).index_add_(0, lab, x)[:k]
    counts = x.new_zeros(k + 1).index_add_(0, lab, torch.ones_like(x[:, 0]))[:k]
    return sums, counts


def _centroid_means(sums, counts, prev):
    new = sums / torch.clamp(counts, min=1.0)[..., None]
    return torch.where(counts[..., None] > 0, new, prev)


def update(x: torch.Tensor, labels: torch.Tensor, k: int, prev: torch.Tensor,
           valid: torch.Tensor | None = None):
    """New centroids = mean of assigned points; empty clusters keep ``prev``.

    ``valid`` masks out padded rows (their labels go to a discard bin).
    Returns (centroids [k, D], counts [k]).
    """
    x = x.to(torch.float32)
    if valid is not None:
        labels = torch.where(valid, labels, k)
    labels = labels.to(torch.int32).contiguous()
    if x.device.type == "cpu":
        sums, counts = _segment_sums(x, labels, k)
    else:
        sums, counts = _update_kernel(x.contiguous(), labels, k)
    return _centroid_means(sums, counts, prev), counts


# ------------------------------------------------- init and the Lloyd loops


def _generator(seed: int, chunk: int | None) -> torch.Generator:
    """The CPU generator of one problem: ``kmeans`` draws from seed's own
    stream, chunk i of ``kmeans_chunked`` from the stream of (seed, i) (the
    JAX package folds i into its key)."""
    entropy = [int(seed)] if chunk is None else [int(seed), int(chunk)]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & 0x7FFF_FFFF_FFFF_FFFF)


def init_centroids(x: torch.Tensor, k: int, seed: int,
                   valid: torch.Tensor | None = None, n_valid=None,
                   chunk_offset: int = 0) -> torch.Tensor:
    """k-means++ D^2-sampling init, batched over chunks (JAX kmeans.py:384-440).

    ``x`` is [P, D] (one problem, seed's own stream) or [C, P, D] (chunk i
    draws from the stream of (seed, chunk_offset + i), so a rank holding
    the chunks from chunk_offset on draws what one device draws for them);
    ``valid`` [P] or [C, P] masks padded rows.  The first centroid is row
    0; then ``rounds`` rounds each draw m = max(1, k // 128) rows from one
    D^2 distribution and write them at slot min(1 + r*m, k - m), so the
    last round may overwrite part of the one before.  Weights are max(d2,
    1e-30): an all-padding chunk samples its pad rows uniformly.  With
    ``n_valid`` and P > 65536 > k the pool is a uniform subsample of 65536
    valid rows.  The uniforms come from CPU
    generators and the sampling (f64 cumsum, searchsorted) runs on x's
    device, so one seed gives one init on every device, and nothing waits
    for the device.
    """
    batched = x.dim() == 3
    xb = x if batched else x[None]
    vb = None if valid is None else (valid if batched else valid[None])
    cc, p, d = xb.shape
    dev = xb.device
    gens = [_generator(seed, chunk_offset + i if batched else None) for i in range(cc)]

    def uniforms(count):
        return torch.stack([torch.rand(count, generator=g, dtype=torch.float64)
                            for g in gens]).to(dev)

    def rows(idx):  # [C, m] row indices -> [C, m, D]
        return torch.gather(xb, 1, idx[:, :, None].expand(-1, -1, d))

    if n_valid is not None and p > _INIT_SUBSAMPLE > k:
        nv = torch.as_tensor(n_valid, dtype=torch.float64).to(dev).reshape(-1, 1)
        xb = rows(torch.clamp((uniforms(_INIT_SUBSAMPLE) * nv).long(), 0, p - 1))
        vb, p = None, _INIT_SUBSAMPLE
    m = max(1, k // 128)
    rounds = -(-(k - 1) // m)
    u = uniforms(rounds * m).view(cc, rounds, m)
    cent = xb.new_zeros((cc, k, d))
    first = xb[:, 0]
    cent[:, 0] = first
    d2 = ((xb - first[:, None, :]) ** 2).sum(-1)
    if vb is not None:
        d2 = torch.where(vb, d2, 0.0)
    x2 = (xb * xb).sum(-1)
    for r in range(rounds):
        cdf = torch.cumsum(torch.clamp(d2.to(torch.float64), min=1e-30), dim=1)
        idx = torch.searchsorted(cdf, u[:, r] * cdf[:, -1:], right=True)
        c = rows(torch.clamp(idx, max=p - 1))
        off = min(1 + r * m, k - m)
        cent[:, off:off + m] = c
        dc = (x2[:, :, None] - 2.0 * torch.bmm(xb, c.transpose(1, 2))
              + (c * c).sum(-1)[:, None, :])
        d2 = torch.minimum(d2, dc.amin(-1))
        if vb is not None:
            d2 = torch.where(vb, d2, 0.0)
    return cent if batched else cent[0]


def _as_points(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        x = data.to(torch.float32)
    else:
        x = torch.as_tensor(np.asarray(data, np.float32)).to(resolve_device(device))
    return x[:, None] if x.dim() == 1 else x


def _fit(xc: torch.Tensor, nv: torch.Tensor, init: torch.Tensor, iters: int,
         precision: str, block_chunks: int | None = None):
    """``iters`` Lloyd steps on [C, P, D] from ``init``, then the final labels
    against the final centroids (one more pass).  On the card in bf16 mode
    x is rounded once here, not in every step: the rounding is idempotent.
    ``block_chunks``: the CPU route's row blocking (``_lloyd_ref``)."""
    rounded = xc.device.type == "cuda" and _lloyd_precision(xc, init, precision) == "bf16"
    if rounded:
        xc = _bf16(xc)
    c = init
    for _ in range(iters):
        sums, counts, _ = _lloyd(xc, c, nv, precision, rounded, block_chunks)
        c = _centroid_means(sums, counts, c)
    _, _, labels = _lloyd(xc, c, nv, precision, rounded, block_chunks)
    return c, labels


def kmeans(data, k: int, max_iter: int = 10, seed: int = 0,
           precision: str = "bf16", device=None):
    """Lloyd iterations with fixed ``max_iter`` (reference gpu_ops.kmeans).

    Returns (centroids [k, D] f32, labels [N] int32) on the data's device:
    a tensor's own, else ``device`` (default the card).  If k >= N the data
    itself are the centroids.  N is padded to a power of two with PAD_POS
    rows, as in the JAX package.
    """
    _check_precision(precision)
    x = _as_points(data, device)
    n = x.shape[0]
    if k >= n:
        return x, torch.arange(n, dtype=torch.int32, device=x.device)
    p = next_pow2(n)
    xp = pad_rows(x, p, PAD_POS).contiguous()
    mesh = _dispatch_mesh(p)
    if mesh is not None:
        from ..parallel.distributed import sharded_kmeans

        c, labels = sharded_kmeans(xp, int(k), mesh, max_iter=int(max_iter),
                                   seed=seed, n_valid=n, precision=precision)
        return c, labels[:n]
    valid = torch.arange(p, device=x.device) < n
    init = init_centroids(xp, int(k), seed, valid=valid, n_valid=n)
    c, labels = _fit(xp[None], _n_valid(n, x.device), init[None], int(max_iter),
                     precision)
    return c[0], labels[0, :n]


def kmeans_chunked(data, num_chunks: int, k_per_chunk: int, max_iter: int = 10,
                   seed: int = 0, precision: str = "bf16", device=None):
    """Locality-chunked K-Means (the SOG shN palette, reference sog.py:526-549):
    equal chunks of consecutive rows, each fitting its own k-means++-seeded
    codebook, every Lloyd step of all chunks in one K2 launch (``max_iter``
    steps, then one more for the final labels).  The dispatch is the span
    ``palette_fit`` with the counters ``chunks``, ``k_per_chunk`` and
    ``lloyd_steps`` (``max_iter``).

    Chunks hold next_pow2(ceil(N / num_chunks), floor=max(256, k)) rows; the
    real rows fill the leading chunks and PAD_POS rows the rest, so trailing
    chunks may hold only padding: their centroids stay at PAD_POS, as in the
    JAX package.  Returns (centroids [num_chunks * k, D], labels [N] offset
    by chunk * k), on the data's device as in ``kmeans``; nothing waits for
    the device.
    """
    _check_precision(precision)
    x = _as_points(data, device)
    n, d = x.shape
    k = int(k_per_chunk)
    chunk = next_pow2(-(-n // num_chunks), floor=max(256, k))
    xp = pad_rows(x, chunk * num_chunks, PAD_POS)
    with span("palette_fit", chunks=int(num_chunks), k_per_chunk=k, lloyd_steps=int(max_iter)):
        mesh = _dispatch_mesh(chunk * num_chunks, chunks=num_chunks)
        if mesh is not None:
            from ..parallel.distributed import sharded_kmeans_chunked

            c, labels = sharded_kmeans_chunked(xp, n, num_chunks, k, int(max_iter), seed,
                                               mesh, precision=precision)
            return c, labels[:n]
        xc = xp.reshape(num_chunks, chunk, d).contiguous()
        first = torch.arange(num_chunks, device=x.device) * chunk
        nv = torch.clamp(n - first, 0, chunk).to(torch.int32)
        valid = torch.arange(chunk, device=x.device)[None, :] < nv[:, None]
        init = init_centroids(xc, k, seed, valid=valid)
        c, labels = _fit(xc, nv, init, int(max_iter), precision)
        offs = (torch.arange(num_chunks, device=x.device, dtype=torch.int32) * k)[:, None]
        return c.reshape(num_chunks * k, d), (labels + offs).reshape(-1)[:n]


def _dispatch_mesh(n_rows: int, chunks: int | None = None):
    """The active mesh iff it has more than one rank and the padded rows
    (and the chunks) split evenly over them: the automatic multi-device
    dispatch, the analogue of the reference's GPU/CPU fallback ladder."""
    from ..parallel.mesh import multi_rank_mesh

    mesh = multi_rank_mesh()
    if mesh is None:
        return None
    if n_rows % mesh.size or (chunks is not None and chunks % mesh.size):
        return None
    return mesh

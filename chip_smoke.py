"""Smoke run of gsconverter_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit; TF32 off;
  2. build: csrc/sor_window.cu (K1), csrc/kmeans.cu (K2's labels, K3)
     and csrc/kmeans_update.cu (K4, also K2's sum stage), one nvcc each,
     all started together, with ptxas's registers, shared memory, spills;
  3. K1 against its plain PyTorch version at two settings on the card
     (4,194,304 points at k=25, sigma=10.5: one pass, window 256, 7 steps;
     1,048,576 points at k=25, sigma=2.0: two passes, window 512, 10 steps):
     md and the full SOR mask, with times and the share of rows equal bit
     for bit; then md alone at window 64 (the kernel's generic
     instantiation, which no sor_mask setting takes);
  4. the main path at full size: a 1M-splat 3DGS PLY through convert() to
     .splat and to 3DGS PLY with the filters bbox, min_opacity=5,
     density_sensitivity=0.5 and sor_intensity=4 on device="cuda", with its
     launch counts, output checks and per-stage times; the same scene to
     .ksplat at levels 0, 1 and 2, to .spz and to compressed PLY, each with
     one K1 launch, as many splats kept as .splat, the file read back and
     its positions within the format's own step of the processed cloud's;
     then convert_batch of the scene to 3dgs, splat, ksplat, spz and
     compressed PLY on the card: one K1 launch, every file byte-identical
     to the standalone card conversion (Parquet is not driven: it has no
     device stage, and the tests hold it on the CPU); then a 20k-splat
     scene with isolated flyers inside the bbox through bbox, min_opacity=5
     and sor_intensity=4 on "cuda" and on "cpu": SOR must drop rows on both
     and the outputs must agree, the .ksplat (levels 0-2), .spz and
     compressed PLY files byte for byte;
  5. K1 against its plain version on the input the main path gave it;
  6. K2 (the Lloyd step: labels kernel, then K4 for the sums) against its
     plain version at the SOG palette's shapes for 3M splats (64 chunks of
     65,536 rows, D=24, the trailing chunks padding only) at k=1024 and
     k=64, bf16 and f32: labels equal on every real row, sums and counts
     bit for bit against its summation order in plain PyTorch, the share
     of real rows the bf16 labels kernel re-checked (its own counter), and
     its kernels' device times by torch.profiler; K3 (assign) and K4
     (update) at N=1,048,576, D=24, K=4096; each with its agreement,
     repeat-identity, times and bound; K3's labels equal to its plain
     version's and its route's plain spec's on every row, also on a u8
     grid with exact ties (262,144 x 24, K=600), with the share of rows it
     re-checked and its kernels' device times by torch.profiler; K4 also
     bit for bit against its summation order in plain PyTorch, timed on a
     skewed input (every label 0), and its kernels' device times by
     torch.profiler;
  7. the SOG path at full width: a 3M-splat, SH-degree-2 scene through
     Converter.run to .sog at compression levels 1 and 10 on the card, with
     K2's and K4's launches (11 each), the writer's stage times, the
     palette fit's own time, and the decoded file checked, its shN error
     within 1.02x of the same fit through K2's plain version; then a
     20k-splat scene to .sog on "cuda" and on "cpu": all but the palette
     entries byte-identical, the palette's reconstruction error within
     1.25x of the CPU's.

The line before the last two is a JSON object listing every ported kernel;
then the card's name and power limit from nvidia-smi; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result
and exits 1.  Everything it writes goes under build/chip_smoke/.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): 67 TFLOP/s FP32
# outside the tensor cores counts a fused multiply-add as two operations,
# so single FP32 instructions (add, mul, compare, max, conversion) issue at
# half that; HBM3 bandwidth.
FP32_INSTR_RATE = 33.5e12
PEAK_BYTES = 3.35e12
# a multiply-add counted as two operations, as the peaks count it
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
# FP32 instructions K1's function needs per (point, candidate) pair, each
# distance computed once: the distance (3 sub, 3 mul, 2 add, sqrt counted
# as one, 2 validity compares, the bf16 round trip: 12), the all-candidate
# stats (count, sum, max: 3), the final pass (compare, count, sum: 3), and
# 2 per bisection step (compare, count).  The middle-block count and max
# add 2 for 512 of the 512 + 2w candidates.
K1_DIST_OPS, K1_STATS_OPS, K1_FINAL_OPS, K1_STEP_OPS, K1_MID_OPS = 12, 3, 3, 2, 2
BBOX = (-60.0, -60.0, -60.0, 60.0, 60.0, 60.0)
EXT = {"splat": ".splat", "3dgs": ".ply", "ksplat": ".ksplat", "spz": ".spz",
       "compressed_ply": ".ply"}
MAIN_FLAGS = dict(bbox=BBOX, min_opacity=5, density_sensitivity=0.5,
                  sor_intensity=4)
# the 20k scene's flags: without the density filter, which would take the
# inner flyers before SOR sees them
SOR_FLAGS = dict(bbox=BBOX, min_opacity=5, sor_intensity=4)
INNER_FLYERS = 10
# (points, k, sigma) of phase 3, and the main path's scene size
K1_SETTINGS = ((4_194_304, 25, 10.5), (1_048_576, 25, 2.0))
# (points, k, window, iters) of phase 3's generic-window check
K1_GENERIC = (1_048_576, 25, 64, 7)
MAIN_N = 1_000_000
# the SOG palette at 3M splats: 64 chunks of 65,536 rows of 24 shN values;
# k per chunk 1024 at level 1, 64 at level 10
SOG_N, SOG_D, SOG_LEVELS, SOG_CHUNKS = 3_000_000, 24, (1, 10), 64
K2_KS = (1024, 64)
K34_N, K34_D, K34_K = 1_048_576, 24, 4096
# (rows, centroids) of K3's u8-grid case with exact ties, at D = K34_D
K3_GRID = (262_144, 600)
SMALL_SOG_N = 20_000
# the main path's other codecs: (label, format, write options)
MAIN_CODECS = (("ksplat_l0", "ksplat", dict(compression_level=0)),
               ("ksplat_l1", "ksplat", dict(compression_level=1)),
               ("ksplat_l2", "ksplat", dict(compression_level=2)),
               ("spz", "spz", dict(compression_level=1)),
               ("compressed_ply", "compressed_ply", {}))
# the batch phase's formats, written with compression_level=BATCH_LEVEL;
# each file must equal the standalone run of the same format and options
BATCH_FORMATS = ("3dgs", "splat", "ksplat", "spz", "compressed_ply")
BATCH_LEVEL = 1
DEVICE = "cuda"
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "build", "chip_smoke")


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    """Mean time of ``fn`` over ``reps`` calls, by CUDA events, after a
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_split_us(fn, reps=10):
    """Mean device time (us) per call of each kernel that ``fn`` launches,
    by torch.profiler over ``reps`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = re.search(r"(\w+_kernel(?:<[^>]*>)?)", evt.key)
        if name and us > 0:
            split[name.group(1)] = split.get(name.group(1), 0.0) + us / reps
    return split


def k1_bound_ms(n, window, iters):
    """Least time for K1's function on the card: the FP32 instructions it
    needs over their issue rate, or its bytes (12 B read and 4 B written a
    point) over the memory rate, whichever is larger."""
    cw = 512 + 2 * window
    per_pair = K1_DIST_OPS + K1_STATS_OPS + K1_FINAL_OPS + K1_STEP_OPS * iters
    ops = n * cw * per_pair + n * 512 * K1_MID_OPS
    nbytes = n * 16
    t_ops, t_bytes = ops / FP32_INSTR_RATE, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k2_bound_ms(rows, k, d, precision):
    """Least time for K2's function: the distance products (2 rows k d
    operations) at the peak for ``precision``, or its bytes (x read once,
    the centroids, the labels, sums and counts written), whichever is
    larger; the segment sums add rows*d, which is noise beside them."""
    ops = 2.0 * rows * k * d
    nbytes = rows * d * 4 + rows * 4 + 2 * k * d * 4 + k * 4
    t_ops, t_bytes = ops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k3_bound_ms(n, k, d, precision="bf16"):
    """K3: the distance products (2 n k d operations) or x, the centroids
    and the labels.  With the exact re-check of rows in doubt no product
    needs the FP32 pipe, so the products count at the bf16 tensor peak;
    ``precision="f32"`` gives the FP32 figure of the chain alone."""
    t_ops = 2.0 * n * k * d / PEAK_FLOPS[precision]
    t_bytes = (n * d * 4 + k * d * 4 + n * 4) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k4_bound_ms(n, k, d):
    """K4: x and the labels read, sums and counts written (n*d adds)."""
    t_ops = n * d / FP32_INSTR_RATE
    t_bytes = (n * d * 4 + n * 4 + k * d * 4 + k * 4) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


class plain_k1:
    """Route sor_mask's pass through K1's plain version while active."""

    def __init__(self, sor):
        self.sor = sor

    def __enter__(self):
        self.orig = self.sor._sor_window_loop_kernel
        self.sor._sor_window_loop_kernel = self.sor._sor_window_loop_ref

    def __exit__(self, *exc):
        self.sor._sor_window_loop_kernel = self.orig
        return False


def first_pass_input(sor, pos):
    """The Morton-sorted positions of sor_mask's first pass (n is already a
    multiple of the kernel's block, so no pad rows)."""
    valid = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    rot, shift = sor._PASS_ORDERS[0]
    key = sor._morton_key(pos, valid, rot, shift)
    return pos[torch.sort(key, stable=True).indices].contiguous()


def compare_k1(sor, spos, k, window, iters, real=None):
    """Kernel against plain version on one sorted input: errors and times."""
    md_k = sor._sor_window_loop_kernel(spos, k, window, iters)
    torch.cuda.synchronize()
    md_p = sor._sor_window_loop_ref(spos, k, window, iters)
    torch.cuda.synchronize()
    if real is not None:
        md_k, md_p = md_k[real], md_p[real]
    if not bool(torch.isfinite(md_k).all()):
        fail("K1 returned non-finite mean distances")
    err = (md_k - md_p).abs()
    max_rel = float((err / md_p.clamp_min(1e-12)).max())
    out = dict(max_rel=max_rel, max_abs_err=float(err.max()),
               frac_exact=float((md_k == md_p).float().mean()))
    out["kernel_ms"] = cuda_ms(
        lambda: sor._sor_window_loop_kernel(spos, k, window, iters), reps=10)
    out["plain_ms"] = cuda_ms(
        lambda: sor._sor_window_loop_ref(spos, k, window, iters), reps=3)
    svalid = spos[:, 0] < sor._D_VALID_MAX
    out["library_ms"] = cuda_ms(
        lambda: sor._sor_window_loop(spos, svalid, k, window, 512, batch=64),
        reps=2)
    out["bound_ms"], out["bound_by"] = k1_bound_ms(spos.shape[0], window, iters)
    if max_rel > 1e-4:
        fail(f"K1 md disagrees with its plain version: max rel {max_rel}")
    return out


def phase_k1_settings(sor):
    """K1 against its plain version at the two settings of the SOR bench."""
    rng = np.random.default_rng(0)
    results = []
    for n, k, sigma in K1_SETTINGS:
        pos = torch.from_numpy(rng.normal(0, 3.0, (n, 3)).astype(np.float32)).to(DEVICE)
        fast = sigma >= 3.0
        window = sor.resolve_window(k) if fast else max(512, sor.resolve_window(k))
        iters, passes = (7, 1) if fast else (10, 2)
        r = compare_k1(sor, first_pass_input(sor, pos), k, window, iters)
        mask_k = sor.sor_mask(pos, k, sigma)
        torch.cuda.synchronize()
        with plain_k1(sor):
            mask_p = sor.sor_mask(pos, k, sigma)
        torch.cuda.synchronize()
        agree = float((mask_k == mask_p).float().mean())
        kept = float(mask_k.float().mean())
        r.update(n=n, k=k, sigma=sigma, window=window, iters=iters,
                 passes=passes, mask_agree=agree, kept=kept)
        log(f"[k1] {json.dumps(r)}")
        if agree < 0.99999:
            fail(f"sor_mask by K1 agrees with its plain version on {agree} of rows")
        if kept < 0.9:
            fail(f"sor_mask kept {kept} of N(0, 3) points")
        results.append(r)
        del pos, mask_k, mask_p
    n, k, window, iters = K1_GENERIC
    pos = torch.from_numpy(rng.normal(0, 3.0, (n, 3)).astype(np.float32)).to(DEVICE)
    generic = compare_k1(sor, first_pass_input(sor, pos), k, window, iters)
    generic.update(n=n, k=k, window=window, iters=iters)
    log(f"[k1] generic window: {json.dumps(generic)}")
    return results, generic


def mint_scene(path, n, seed=0, flyers=0.002, inner=0):
    """A synthetic n-splat 3DGS PLY, SH degree 2: a dense N(0, 2) blob,
    ``inner`` isolated flyers 25-45 from it inside the bbox, and 0.2%
    flyers at +80 outside it, written by the port's own writer."""
    from gsconverter_tpu_torch.cloud import SplatCloud
    from gsconverter_tpu_torch.formats import get_handler

    rr = np.random.default_rng(seed)
    nf = int(n * flyers)
    u = rr.normal(size=(inner, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = np.concatenate([rr.normal(0, 2.0, (n - nf - inner, 3)),
                          u * rr.uniform(25.0, 45.0, (inner, 1)),
                          rr.normal(0, 2.0, (nf, 3)) + 80.0]).astype(np.float32)
    quat = rr.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    rest = np.zeros((n, 3, 15), np.float32)
    rest[:, :, :8] = rr.normal(0, 0.1, (n, 3, 8))
    cloud = SplatCloud(
        pos=pos,
        sh_dc=rr.normal(0, 0.5, (n, 3)).astype(np.float32),
        sh_rest=rest,
        opacity=rr.normal(1, 2, (n,)).astype(np.float32),
        log_scale=rr.normal(-4, 0.5, (n, 3)).astype(np.float32),
        quat=quat,
        normal=np.zeros((n, 3), np.float32),
        active_sh_degree=2,
    )
    get_handler("3dgs").write(cloud, path)


def check_output(fmt, path, n_kept):
    from gsconverter_tpu_torch.formats import get_handler

    if fmt == "splat" and os.path.getsize(path) != 32 * n_kept:
        fail(f".splat holds {os.path.getsize(path)} B for {n_kept} splats")
    back = get_handler("splat" if fmt == "splat" else "3dgs").read(path)
    pos = np.asarray(back.pos)
    if back.n != n_kept:
        fail(f"{fmt} output decodes to {back.n} splats, {n_kept} were kept")
    for name in ("pos", "opacity", "log_scale", "quat", "sh_dc"):
        if not np.isfinite(np.asarray(getattr(back, name))).all():
            fail(f"{fmt} output has non-finite {name}")
    if (pos < np.float32(-60)).any() or (pos > np.float32(60)).any():
        fail(f"{fmt} output has splats outside the bbox")


def file_digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def codec_pos_step(fmt, opts, path, handler, n):
    """Each row's position step in a file of ``fmt`` (the error its decode
    may carry, one step, twice the rounding's half step): 0 for .ksplat
    level 0 (f32), block_size / 2 / 32767 at levels 1-2, 1/4096 for .spz
    (24-bit fixed point, 12 fractional bits), and the 11-10-11 step of the
    row's chunk bounds for compressed PLY."""
    from gsconverter_tpu_torch.utils import ply

    if fmt == "ksplat":
        if not opts.get("compression_level"):
            return np.zeros((n, 3))
        block = handler.metadata["sections"][0]["bucketBlockSize"]
        return np.full((n, 3), block / 2.0 / 32767)
    if fmt == "spz":
        return np.full((n, 3), 1.0 / 4096)
    chunks = ply.read(path)["chunk"].data
    mins = np.stack([chunks[f"min_{a}"] for a in "xyz"], axis=1).astype(np.float64)
    maxs = np.stack([chunks[f"max_{a}"] for a in "xyz"], axis=1).astype(np.float64)
    return ((maxs - mins) / np.array([2047.0, 1023.0, 2047.0]))[np.arange(n) // 256]


def check_codec_output(fmt, opts, path, processed):
    """Read a .ksplat, .spz or compressed PLY back: every splat, finite
    leaves, positions within the format's step of the processed cloud's (in
    the writer's order: Morton for .ksplat level >= 1 and compressed PLY)."""
    from gsconverter_tpu_torch.formats import get_handler
    from gsconverter_tpu_torch.formats.compressed_ply import morton_order

    handler = get_handler(fmt)
    back = handler.read(path)
    if back.n != processed.n:
        fail(f"{fmt} {opts} decodes to {back.n} splats, {processed.n} were kept")
    for name in ("pos", "opacity", "log_scale", "quat", "sh_dc", "sh_rest"):
        if not np.isfinite(np.asarray(getattr(back, name))).all():
            fail(f"{fmt} {opts} output has non-finite {name}")
    ref = np.asarray(processed.pos)
    if fmt == "compressed_ply" or (fmt == "ksplat" and opts.get("compression_level")):
        ref = ref[morton_order(ref)]
    step = codec_pos_step(fmt, opts, path, handler, back.n)
    err = np.abs(back.pos.astype(np.float64) - ref)
    # f32 roundings of the decode on top of the step
    slack = 1e-6 * (1.0 + np.abs(ref))
    within = bool((err <= step + slack).all())
    worst = float((err / np.maximum(step, 1e-30)).max()) if step.any() else float(err.max())
    out = dict(positions_within_step=within, pos_err_steps=worst,
               step_max=float(step.max()))
    if not within:
        fail(f"{fmt} {opts} positions lie beyond the format's step: {json.dumps(out)}")
    return out


class sor_stage_spy:
    """Rows into and out of the port's SOR stage (``filters.remove_flyers``)
    while active."""

    def __init__(self):
        from gsconverter_tpu_torch.ops import filters
        self.filters, self.calls = filters, []

    def __enter__(self):
        self.orig = orig = self.filters.remove_flyers

        def spy(cloud, *args, **kwargs):
            out = orig(cloud, *args, **kwargs)
            self.calls.append((cloud.n, out.n))
            return out

        self.filters.remove_flyers = spy
        return self

    def __exit__(self, *exc):
        self.filters.remove_flyers = self.orig
        return False


def phase_main_path(sor, smi):
    """The 1M-splat conversions on the card, with K1's main-path input."""
    from gsconverter_tpu_torch.converter import Converter

    src = os.path.join(OUT_DIR, "scene_main.ply")
    t0 = time.perf_counter()
    mint_scene(src, MAIN_N)
    log(f"[main] minted {MAIN_N}-splat scene in {time.perf_counter() - t0:.2f} s")

    seen = []
    wrapper = sor._sor_window_loop_kernel

    def spy(spos, k, window, iters):
        # a reference, not a copy: sor_mask never writes to it again
        if not seen:
            seen.append((spos, k, window, iters))
        return wrapper(spos, k, window, iters)

    sor._sor_window_loop_kernel = spy
    runs = {}
    try:
        for fmt, ext in (("splat", ".splat"), ("3dgs", ".ply")):
            out = os.path.join(OUT_DIR, f"out_main{ext}")
            conv = Converter(src, out, fmt, device=DEVICE)
            with sor_stage_spy() as stage:
                sor.KERNEL_LAUNCHES = 0
                t0 = time.perf_counter()
                cloud = conv.run(**MAIN_FLAGS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = sor.KERNEL_LAUNCHES
            if launches < 1:
                fail(f"ply -> {fmt} never launched K1")
            (sor_in, sor_out), = stage.calls
            check_output(fmt, out, cloud.n)
            # the 0.2% flyers sit outside the bbox
            if not 0 < cloud.n <= 0.998 * MAIN_N:
                fail(f"ply -> {fmt} kept {cloud.n} of {MAIN_N} splats")
            runs[fmt] = dict(kept=cloud.n, wall_s=wall, launches=launches,
                             sor_in=sor_in, sor_removed=sor_in - sor_out,
                             stages_s=conv.timer.report())
            log(f"[main] ply -> {fmt} on {smi}: {json.dumps(runs[fmt])}")
            runs[fmt]["sha256"] = file_digest(out)
            os.unlink(out)
    finally:
        sor._sor_window_loop_kernel = wrapper
    if runs["splat"]["kept"] != runs["3dgs"]["kept"]:
        fail("ply -> splat and ply -> 3dgs kept different splats")
    if runs["splat"]["launches"] != runs["3dgs"]["launches"]:
        fail("ply -> splat and ply -> 3dgs launched K1 a different number of times")
    for label, fmt, opts in MAIN_CODECS:
        out = os.path.join(OUT_DIR, f"out_main_{label}{EXT[fmt]}")
        conv = Converter(src, out, fmt, device=DEVICE)
        sor.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        cloud = conv.run(**MAIN_FLAGS, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = sor.KERNEL_LAUNCHES
        if launches != 1:
            fail(f"ply -> {label} launched K1 {launches} times, not once")
        if cloud.n != runs["splat"]["kept"]:
            fail(f"ply -> {label} kept {cloud.n} splats, ply -> splat {runs['splat']['kept']}")
        runs[label] = dict(kept=cloud.n, wall_s=wall, launches=launches,
                           bytes=os.path.getsize(out), stages_s=conv.timer.report(),
                           check=check_codec_output(fmt, opts, out, conv.processed_cloud))
        runs[label]["sha256"] = file_digest(out)
        log(f"[main] ply -> {label} on {smi}: {json.dumps(runs[label])}")
        os.unlink(out)
    return runs, seen[0], src


def phase_batch(sor, smi, src, runs):
    """convert_batch of the main scene on the card: one read and filter
    chain, so one K1 launch, and every file byte-identical to the standalone
    card conversion of its format."""
    from gsconverter_tpu_torch.batch import convert_batch

    standalone = {"3dgs": "3dgs", "splat": "splat", "ksplat": f"ksplat_l{BATCH_LEVEL}",
                  "spz": "spz", "compressed_ply": "compressed_ply"}
    out_dir = os.path.join(OUT_DIR, "batch")
    sor.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    done = convert_batch(src, out_dir, list(BATCH_FORMATS), device=DEVICE,
                         compression_level=BATCH_LEVEL, **MAIN_FLAGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sor.KERNEL_LAUNCHES
    same = {fmt: file_digest(out) == runs[standalone[fmt]]["sha256"] for _, fmt, out in done}
    r = dict(formats=[fmt for _, fmt, _ in done], wall_s=wall, launches=launches,
             identical_to_standalone=same,
             standalone_wall_sum_s=sum(runs[standalone[f]]["wall_s"] for f in BATCH_FORMATS))
    log(f"[batch] ply -> {', '.join(r['formats'])} on {smi}: {json.dumps(r)}")
    log("[batch] parquet: not driven on the card (the codec has no device stage "
        "and needs pandas); tests/test_torch_codecs.py and tests/test_torch_batch.py "
        "hold it on the CPU")
    if launches != 1:
        fail(f"the batch launched K1 {launches} times, not once")
    if sorted(same) != sorted(BATCH_FORMATS) or not all(same.values()):
        fail(f"batch files differ from the standalone card runs: {json.dumps(same)}")
    shutil.rmtree(out_dir)
    return r


def phase_small_agreement(sor):
    """A 20k-splat scene with isolated flyers inside the bbox, through bbox,
    alpha and SOR on the card and on the CPU (where K1's plain version
    runs): SOR drops rows on both, and the outputs agree."""
    from gsconverter_tpu_torch import convert

    src = os.path.join(OUT_DIR, "scene_20k.ply")
    mint_scene(src, 20_000, seed=1, inner=INNER_FLYERS)
    out = {}
    for dev in (DEVICE, "cpu"):
        path = os.path.join(OUT_DIR, f"small_{dev}.splat")
        with sor_stage_spy() as stage:
            sor.KERNEL_LAUNCHES = 0
            cloud = convert(src, path, "splat", device=dev, **SOR_FLAGS)
            launched = sor.KERNEL_LAUNCHES
        (sor_in, sor_out), = stage.calls
        with open(path, "rb") as f:
            out[dev] = dict(kept=cloud.n, data=f.read(), launches=launched,
                            sor_removed=sor_in - sor_out)
    gpu, cpu = out[DEVICE], out["cpu"]
    same = gpu["data"] == cpu["data"]
    log(f"[small] 20k scene: SOR removed {gpu['sor_removed']} on {DEVICE}, "
        f"{cpu['sor_removed']} on cpu; kept {gpu['kept']} and {cpu['kept']}; "
        f"byte-identical={same}")
    if gpu["launches"] < 1:
        fail("the 20k scene never launched K1")
    if gpu["sor_removed"] < 1 or cpu["sor_removed"] < 1:
        fail("SOR removed no row of the 20k scene")
    if not same and abs(gpu["kept"] - cpu["kept"]) > 0.001 * 20_000:
        fail("the 20k scene differs between cuda and cpu by more than 0.1%")
    codecs = {}
    for label, fmt, opts in MAIN_CODECS:
        data = {}
        for dev in (DEVICE, "cpu"):
            path = os.path.join(OUT_DIR, f"small_{label}_{dev}{EXT[fmt]}")
            sor.KERNEL_LAUNCHES = 0
            cloud = convert(src, path, fmt, device=dev, **SOR_FLAGS, **opts)
            data[dev] = (cloud.n, file_digest(path), sor.KERNEL_LAUNCHES)
            os.unlink(path)
        codecs[label] = data[DEVICE][:2] == data["cpu"][:2]
        if data[DEVICE][2] != 1:
            fail(f"the 20k scene to {label} launched K1 {data[DEVICE][2]} times, not once")
    log(f"[small] 20k scene, cuda vs cpu byte-identical: {json.dumps(codecs)}")
    if not all(codecs.values()):
        fail(f"the 20k scene's files differ between cuda and cpu: {json.dumps(codecs)}")
    os.unlink(src)
    return same


def sog_rows(n, d, seed):
    """n rows of d SH values N(0, 0.1), u8-quantized and dequantized as the
    SOG writer hands them to K2 (on the card)."""
    from gsconverter_tpu_torch.formats import sog

    rest = np.random.default_rng(seed).normal(0, 0.1, (n, d)).astype(np.float32)
    q8, scale, mn = sog.shn_u8(rest, n, d)
    return sog._dequant_u8(torch.from_numpy(q8).to(DEVICE), scale, mn)


def chunked_inputs(km, x, chunks, k):
    """The chunk layout, n_valid and k-means++ init of kmeans_chunked."""
    from gsconverter_tpu_torch.ops.padding import PAD_POS, next_pow2, pad_rows

    n, d = x.shape
    chunk = next_pow2(-(-n // chunks), floor=max(256, k))
    xc = pad_rows(x, chunk * chunks, PAD_POS).reshape(chunks, chunk, d).contiguous()
    nv = torch.clamp(n - torch.arange(chunks, device=x.device) * chunk, 0, chunk)
    nv = nv.to(torch.int32)
    valid = torch.arange(chunk, device=x.device)[None, :] < nv[:, None]
    return xc, km.init_centroids(xc, k, 100, valid=valid), nv


def compare_k2(km, xc, c, nv, precision):
    """K2 against its plain version on one batched input: labels, sums and
    counts against ``_lloyd_ref``, and bit for bit against
    ``_lloyd_ordered_ref`` (K4's summation order)."""
    s1, n1, l1 = km._lloyd_kernel(xc, c, nv, precision)
    # rows the labels kernel re-checked, as its counter says
    recheck_share = float(km.LAST_RECHECKED.sum()) / float(nv.sum())
    torch.cuda.synchronize()
    s2, n2, l2 = km._lloyd_ref(xc, c, nv, precision)
    torch.cuda.synchronize()
    chunks, rows, d = xc.shape
    k = c.shape[1]
    real = torch.arange(rows, device=xc.device)[None, :] < nv[:, None]
    mism = (l1 != l2) & real
    agree = 1.0 - float(mism.sum()) / float(real.sum())
    # clusters whose membership agrees: no disagreeing row on either side
    offs = (torch.arange(chunks, device=xc.device) * k)[:, None]
    bad = torch.zeros(chunks * k, dtype=torch.bool, device=xc.device)
    bad[(l1.long() + offs)[mism]] = True
    bad[(l2.long() + offs)[mism]] = True
    same = ~bad.view(chunks, k)
    counts_equal = bool(torch.equal(n1[same], n2[same]))
    err = (s1 - s2)[same].abs()
    sums_close = bool(torch.isclose(s1, s2, rtol=1e-5, atol=1e-4)[same].all())
    del s2, n2, l2
    so, no, _ = km._lloyd_ordered_ref(xc, c, nv, precision)
    ordered = bool(torch.equal(s1, so) and torch.equal(n1, no))
    del so, no
    s3, n3, l3 = km._lloyd_kernel(xc, c, nv, precision)
    repeat = bool(torch.equal(s1, s3) and torch.equal(n1, n3) and torch.equal(l1, l3))
    # as _fit calls it: x rounded to bf16 once per fit, not in every step
    rounded = precision == "bf16"
    xr = km._bf16(xc) if rounded else xc
    s3, n3, l3 = km._lloyd_kernel(xr, c, nv, precision, rounded)
    repeat &= bool(torch.equal(s1, s3) and torch.equal(n1, n3) and torch.equal(l1, l3))
    del s3, n3, l3
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    xb, ct = xc.to(dt), c.transpose(1, 2).to(dt)
    out = dict(precision=precision, chunks=chunks, rows=rows, d=d, k=k,
               label_agree=agree, counts_equal=counts_equal, sums_close=sums_close,
               sums_ordered_equal=ordered, recheck_share=recheck_share,
               max_abs_err=float(err.max()), repeat_identical=repeat,
               kernel_ms=cuda_ms(lambda: km._lloyd_kernel(xr, c, nv, precision, rounded),
                                 reps=5),
               # a call on unrounded x, which rounds it first
               kernel_rounding_ms=cuda_ms(lambda: km._lloyd_kernel(xc, c, nv, precision),
                                          reps=5),
               device_split_us=device_split_us(
                   lambda: km._lloyd_kernel(xr, c, nv, precision, rounded), reps=5),
               plain_ms=cuda_ms(lambda: km._lloyd_ref(xc, c, nv, precision), reps=1,
                                warmup=0),
               matmul_ms=cuda_ms(lambda: torch.bmm(xb, ct), reps=3))
    del xb, ct, xr
    out["bound_ms"], out["bound_by"] = k2_bound_ms(chunks * rows, k, d, precision)
    if agree < 1.0 or not counts_equal or not sums_close or not ordered or not repeat:
        fail(f"K2 disagrees with its plain version: {json.dumps(out)}")
    return out


def phase_k2(km):
    """K2 at the SOG palette's shapes for SOG_N splats."""
    x = sog_rows(SOG_N, SOG_D, seed=5)
    results = []
    for k in K2_KS:
        xc, c, nv = chunked_inputs(km, x, SOG_CHUNKS, k)
        for precision in ("bf16", "f32"):
            r = compare_k2(km, xc, c, nv, precision)
            log(f"[k2] {json.dumps(r)}")
            results.append(r)
        del xc, c, nv
    return results


def compare_k3(km, x, c):
    """K3 against its plain version and its route's plain spec on one
    input: labels equal on every row, repeat-identity, the share of rows
    re-checked (the kernel's counter, and the spec's)."""
    l1 = km._assign_kernel(x, c)
    listed = int(km.LAST_ASSIGN_RECHECKED)
    torch.cuda.synchronize()
    l2 = km._assign_ref(x, c)
    spec, spec_listed = km._assign_split_ref(x, c)
    n = x.shape[0]
    # where labels differ, how far apart the two chosen distances are
    dist = lambda lab: ((x - c[lab.long()]) ** 2).sum(1)  # noqa: E731
    out = dict(n=n, d=x.shape[1], k=c.shape[0],
               label_agree=float((l1 == l2).float().mean()),
               spec_equal=bool(torch.equal(l1, spec)),
               max_abs_err=float((dist(l1) - dist(l2)).abs().max()),
               repeat_identical=bool(torch.equal(l1, km._assign_kernel(x, c))),
               recheck_share=listed / n, spec_recheck_share=spec_listed / n)
    return out, l1


def phase_k3_k4(km):
    """K3 and K4 at K34_N points, K34_D dims, K34_K centroids; K3 also on a
    u8 grid with exact ties."""
    rr = np.random.default_rng(6)
    x = torch.from_numpy(rr.normal(0, 1, (K34_N, K34_D)).astype(np.float32)).to(DEVICE)
    c = x[torch.from_numpy(rr.choice(K34_N, K34_K, replace=False)).to(DEVICE)].contiguous()
    k3, l1 = compare_k3(km, x, c)
    k3.update(kernel_ms=cuda_ms(lambda: km._assign_kernel(x, c), reps=5),
              device_split_us=device_split_us(lambda: km._assign_kernel(x, c), reps=5),
              plain_ms=cuda_ms(lambda: km._assign_ref(x, c), reps=1, warmup=0),
              matmul_ms=cuda_ms(lambda: x @ c.T, reps=3))
    k3["bound_ms"], k3["bound_by"] = k3_bound_ms(K34_N, K34_K, K34_D)
    k3["fp32_bound_ms"] = k3_bound_ms(K34_N, K34_K, K34_D, "f32")[0]
    # SOG's dequantized u8 grid, centroids duplicated in other tiles and
    # rows sitting on them: exact ties, the lower index must win
    g = (np.float32(-1.57) + np.float32(0.0123)
         * rr.integers(0, 256, (K3_GRID[0], K34_D))).astype(np.float32)
    gc = g[rr.choice(K3_GRID[0], K3_GRID[1], replace=False)].copy()
    gc[300], gc[550] = gc[5], gc[260]
    g[:1000], g[1000:2000] = gc[5], gc[260]
    gx, gc = torch.from_numpy(g).to(DEVICE), torch.from_numpy(gc).to(DEVICE)
    ties, gl = compare_k3(km, gx, gc)
    ties["ties_to_lowest"] = bool((gl[:1000] == 5).all() and (gl[1000:2000] == 260).all())
    ties["kernel_ms"] = cuda_ms(lambda: km._assign_kernel(gx, gc), reps=5)
    k3["grid_ties"] = ties
    log(f"[k3] {json.dumps(k3)}")
    for r in (k3, ties):
        if r["label_agree"] < 1.0 or not r["spec_equal"] or not r["repeat_identical"]:
            fail(f"K3 disagrees with its plain version: {json.dumps(k3)}")
    if not ties["ties_to_lowest"]:
        fail(f"K3 broke an exact tie to a higher index: {json.dumps(ties)}")
    del gx, gc, gl
    s1, n1 = km._update_kernel(x, l1, K34_K)
    torch.cuda.synchronize()
    s2, n2 = km._update_ref(x, l1, K34_K)
    s3, n3 = km._update_kernel(x, l1, K34_K)
    so, no = km._update_ordered_ref(x, l1, K34_K)
    # the skewed input: one cluster of N / 256 pieces
    zero = torch.zeros_like(l1)
    sz, nz = km._update_kernel(x, zero, K34_K)
    szo, nzo = km._update_ordered_ref(x, zero, K34_K)
    lab64 = l1.long()
    k4 = dict(n=K34_N, d=K34_D, k=K34_K, counts_equal=bool(torch.equal(n1, n2)),
              sums_close=bool(torch.isclose(s1, s2, rtol=1e-5, atol=1e-4).all()),
              max_abs_err=float((s1 - s2).abs().max()),
              ordered_equal=bool(torch.equal(s1, so) and torch.equal(n1, no)),
              skew_ordered_equal=bool(torch.equal(sz, szo) and torch.equal(nz, nzo)),
              repeat_identical=bool(torch.equal(s1, s3) and torch.equal(n1, n3)),
              kernel_ms=cuda_ms(lambda: km._update_kernel(x, l1, K34_K), reps=20),
              skew_ms=cuda_ms(lambda: km._update_kernel(x, zero, K34_K), reps=20),
              plain_ms=cuda_ms(lambda: km._update_ref(x, l1, K34_K), reps=1, warmup=0),
              library_ms=cuda_ms(
                  lambda: torch.zeros(K34_K, K34_D, device=DEVICE).index_add_(0, lab64, x),
                  reps=20),
              split_us=device_split_us(lambda: km._update_kernel(x, l1, K34_K)),
              skew_split_us=device_split_us(lambda: km._update_kernel(x, zero, K34_K)))
    k4["bound_ms"], k4["bound_by"] = k4_bound_ms(K34_N, K34_K, K34_D)
    log(f"[k4] {json.dumps(k4)}")
    if not (k4["counts_equal"] and k4["sums_close"] and k4["repeat_identical"]
            and k4["ordered_equal"] and k4["skew_ordered_equal"]):
        fail(f"K4 disagrees with its plain versions: {json.dumps(k4)}")
    return k3, k4


def sog_stage_times(text):
    """Stage times (ms) from a run with timing on: the converter's stages
    and the SOG writer's sog.* stages."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"\[timing\] ([\w.+]+): ([0-9.]+) ms", text)}


def corr_per_channel(a, b):
    return [float(np.corrcoef(a[:, ch].ravel(), b[:, ch].ravel())[0, 1]) for ch in range(3)]


def plain_fit(km, x, chunks, k, iters=10):
    """kmeans_chunked's fit of x (same chunk layout, init and seed as the
    writer's) with every Lloyd step through K2's plain version at bf16."""
    n, d = x.shape
    xc, c, nv = chunked_inputs(km, x, chunks, k)
    for _ in range(iters):
        sums, counts, _ = km._lloyd_ref(xc, c, nv, "bf16")
        c = km._centroid_means(sums, counts, c)
    _, _, labels = km._lloyd_ref(xc, c, nv, "bf16")
    offs = (torch.arange(chunks, device=x.device, dtype=torch.int32) * k)[:, None]
    return c.reshape(chunks * k, d), (labels + offs).reshape(-1)[:n]


def palette_mse(x, fit):
    """Mean squared error of x against its palette reconstruction."""
    c, labels = fit
    return float(((x - c[labels.long()]) ** 2).mean())


def check_sog_output(path, src_cloud, order, x, fit, plain):
    """Decode a written .sog and hold it against its source, the palette fit
    that wrote it and the same fit through K2's plain version: every splat,
    finite, positions within the u16 log step, the file's palette labels
    equal to the fit's, the decoded SH against the fit's reconstruction,
    and the decoded SH's error against x (the writer's dequantized input)
    within 1.02x of the plain fit's palette error."""
    from gsconverter_tpu_torch.formats import get_handler, sog

    back = get_handler("sog").read(path)
    n = back.n
    if n != src_cloud.n:
        fail(f".sog decodes to {n} splats, {src_cloud.n} were written")
    for name in ("pos", "opacity", "log_scale", "quat", "sh_dc", "sh_rest"):
        if not np.isfinite(np.asarray(getattr(back, name))).all():
            fail(f".sog output has non-finite {name}")
    with zipfile.ZipFile(path) as zf:
        meta = json.load(zf.open("meta.json"))
        lraw = sog._read_webp_flat(zf, "shN_labels.webp", n)
    labels = lraw[:, 0].astype(np.int64) | (lraw[:, 1].astype(np.int64) << 8)
    c, l = fit
    same_labels = bool(np.array_equal(labels, l.cpu().numpy()))
    pos = np.asarray(src_cloud.pos)[order]
    step = (np.array(meta["means"]["maxs"]) - np.array(meta["means"]["mins"])) / 65535.0
    # log|p| is truncated to u16, losing up to one step; 1.5 steps leave
    # room for the f32 roundings of the decode
    pos_err = np.abs(back.pos - pos) / ((np.abs(pos) + 1.0) * step)
    pos_ok = bool(pos_err.max() <= 1.5)
    dim = 8
    src = np.asarray(src_cloud.sh_rest)[order][:, :, :dim]
    dec = back.sh_rest[:, :, :dim]
    recon = c.cpu().numpy()[l.cpu().numpy()].reshape(n, 3, dim)
    out = dict(n=n, positions_within_step=pos_ok, pos_err_steps=float(pos_err.max()),
               labels_equal_fit=same_labels,
               corr_decoded_vs_fit=corr_per_channel(dec, recon),
               corr_decoded_vs_source=corr_per_channel(dec, src),
               mse_vs_source=float(((dec - src) ** 2).mean()),
               var_source=float(src.var()),
               mse_file_vs_x=float(((dec - x.cpu().numpy().reshape(n, 3, dim)) ** 2).mean()),
               mse_fit_vs_x=palette_mse(x, fit),
               mse_plain_fit_vs_x=palette_mse(x, plain))
    out["mse_ratio_file_vs_plain"] = out["mse_file_vs_x"] / out["mse_plain_fit_vs_x"]
    if not pos_ok or not same_labels or min(out["corr_decoded_vs_fit"]) <= 0.99 \
            or out["mse_vs_source"] >= out["var_source"] \
            or out["mse_ratio_file_vs_plain"] > 1.02:
        fail(f".sog output check failed: {json.dumps(out)}")
    return out


def phase_sog(km, smi):
    """ply -> sog at full width, levels 1 and 10, on the card."""
    from gsconverter_tpu_torch.converter import Converter
    from gsconverter_tpu_torch.formats import get_handler, sog

    src = os.path.join(OUT_DIR, "scene_sog.ply")
    t0 = time.perf_counter()
    mint_scene(src, SOG_N, seed=2, flyers=0.0)
    log(f"[sog] minted {SOG_N}-splat scene in {time.perf_counter() - t0:.2f} s")
    src_cloud = get_handler("3dgs").read(src)
    order = sog.morton_order(np.ascontiguousarray(src_cloud.pos))
    q8, scale, mn = sog.shn_u8(np.asarray(src_cloud.sh_rest)[:, :, :8], SOG_N, SOG_D)
    x = sog._dequant_u8(torch.from_numpy(q8[order]).to(DEVICE), scale, mn)
    del q8
    runs = {}
    for level in SOG_LEVELS:
        out = os.path.join(OUT_DIR, f"out_{level}.sog")
        conv = Converter(src, out, "sog", device=DEVICE)
        buf = io.StringIO()
        km.LAUNCHES.update(dict.fromkeys(km.LAUNCHES, 0))
        with contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            conv.run(compression_level=level, timing=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(km.LAUNCHES)
        chunks, k = sog.palette_size(SOG_N, level)
        # the palette fit alone, synchronised: the same input and seed as
        # the writer's, so the same (deterministic) result
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = km.kmeans_chunked(x, chunks, k, max_iter=10, seed=100)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain = plain_fit(km, x, chunks, k)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        r = dict(level=level, chunks=chunks, k_per_chunk=k, wall_s=wall,
                 launches=launches, palette_fit_s=fit_s, plain_fit_s=plain_s,
                 stages_ms=sog_stage_times(buf.getvalue()),
                 check=check_sog_output(out, src_cloud, order, x, fit, plain))
        log(f"[sog] ply -> sog level {level} on {smi}: {json.dumps(r)}")
        if launches["lloyd"] != 11 or launches["update"] != 11:
            fail(f"ply -> sog level {level} launched K2 {launches['lloyd']} and K4 "
                 f"{launches['update']} times, not 11 each")
        os.unlink(out)
        runs[level] = r
    os.unlink(src)
    return runs


def phase_small_sog():
    """A 20k-splat scene to .sog on the card and on the CPU."""
    from gsconverter_tpu_torch import convert
    from gsconverter_tpu_torch.formats import get_handler, sog

    src = os.path.join(OUT_DIR, "scene_sog_20k.ply")
    mint_scene(src, SMALL_SOG_N, seed=3, flyers=0.0)
    src_cloud = get_handler("3dgs").read(src)
    ref = np.asarray(src_cloud.sh_rest)[sog.morton_order(np.asarray(src_cloud.pos))]
    out = {}
    for dev in (DEVICE, "cpu"):
        path = os.path.join(OUT_DIR, f"small_{dev}.sog")
        with contextlib.redirect_stdout(io.StringIO()):
            convert(src, path, "sog", device=dev, compression_level=1)
        with zipfile.ZipFile(path) as zf:
            entries = [(i.filename, zf.read(i.filename)) for i in zf.infolist()]
        back = get_handler("sog").read(path).sh_rest
        out[dev] = dict(entries=entries, mse=float(((back - ref)[:, :, :8] ** 2).mean()))
    gpu, cpu = dict(out[DEVICE]["entries"]), dict(out["cpu"]["entries"])
    palette = ("shN_centroids.webp", "shN_labels.webp", "meta.json")
    same = [name for name in gpu if name not in palette and gpu[name] == cpu.get(name)]
    metas = [json.loads(m["meta.json"]) for m in (gpu, cpu)]
    for m in metas:
        m["shN"].pop("codebook")
    r = dict(n=SMALL_SOG_N, identical_entries=same, meta_equal=metas[0] == metas[1],
             mse_cuda=out[DEVICE]["mse"], mse_cpu=out["cpu"]["mse"])
    log(f"[sog] 20k scene, cuda vs cpu: {json.dumps(r)}")
    if len(same) != len(gpu) - 3 or list(gpu) != list(cpu) or not r["meta_equal"]:
        fail("the 20k .sog differs between cuda and cpu outside the palette")
    if r["mse_cuda"] > 1.25 * r["mse_cpu"]:
        fail("the 20k .sog palette on cuda reconstructs worse than 1.25x the cpu's")
    os.unlink(src)
    return r


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1

    # 1. device
    card = torch.cuda.get_device_name(0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[device] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    from gsconverter_tpu_torch.ops import kmeans as km
    from gsconverter_tpu_torch.ops import sor
    from gsconverter_tpu_torch.utils import cuda_build

    # 2. build: one nvcc per source, all started together
    sources = ("sor_window", "kmeans", "kmeans_update")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.build, sources))
    log(f"[build] {', '.join(sources)} built in {time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in cuda_build.BUILD_LOG.get(name, "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    os.makedirs(OUT_DIR, exist_ok=True)
    t_all = time.perf_counter()
    # 3. K1 at the SOR bench's settings
    settings, generic = phase_k1_settings(sor)
    # 4. the main path
    runs, (spos, k, window, iters), main_src = phase_main_path(sor, smi)
    batch = phase_batch(sor, smi, main_src, runs)
    os.unlink(main_src)
    small_same = phase_small_agreement(sor)
    # 5. K1 on the main path's own input
    real = spos[:, 0] < sor._D_VALID_MAX
    r = compare_k1(sor, spos, k, window, iters, real=real)
    r.update(n=spos.shape[0], k=k, window=window, iters=iters)
    log(f"[k1] main-path input: {json.dumps(r)}")
    # 6. K2, K3, K4 against their plain versions
    k2 = phase_k2(km)
    k3, k4 = phase_k3_k4(km)
    # 7. the SOG path
    sog_runs = phase_sog(km, smi)
    small_sog = phase_small_sog()
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    log(f"[done] phases 3-7 in {time.perf_counter() - t_all:.1f} s; "
        f"small scene byte-identical={small_same}; "
        f"small .sog cuda/cpu mse {small_sog['mse_cuda']:.6g}/{small_sog['mse_cpu']:.6g}")

    kernels = [{
        "name": "K1 sor_window_md",
        "route": "cuda",
        "source": "gsconverter_tpu_torch/csrc/sor_window.cu",
        "replaces": "gsconverter_tpu/ops/sor.py:315",
        "launches": runs["splat"]["launches"],
        # one a conversion on every path of config 2, and one a batch scene
        "launches_by_path": dict({label: run["launches"] for label, run in runs.items()},
                                 batch=batch["launches"]),
        "max_abs_err": r["max_abs_err"],
        "max_rel": r["max_rel"],
        "ms": r["kernel_ms"],  # the key the harness reads
        "kernel_ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "frac_exact": r["frac_exact"],
        "main_path_shape": {"n": r["n"], "k": k, "window": window, "iters": iters},
        "settings": settings,
        "generic_window": generic,
    }]
    # K2's main path: level 1 of the SOG path (bf16, k=1024)
    main_k2 = next(x for x in k2 if x["k"] == K2_KS[0] and x["precision"] == "bf16")
    kmeans_src = "gsconverter_tpu_torch/csrc/kmeans.cu"
    update_src = "gsconverter_tpu_torch/csrc/kmeans_update.cu"
    kernels += [{
        "name": "K2 kmeans_lloyd (labels kernel, then K4 for the sums)",
        "route": "cuda",
        "source": kmeans_src,
        "sources": [kmeans_src, update_src],  # labels; the sum stage
        "replaces": "gsconverter_tpu/ops/kmeans.py:264",
        "launches": sog_runs[SOG_LEVELS[0]]["launches"]["lloyd"],
        "launches_by_level": {lv: run["launches"]["lloyd"] for lv, run in sog_runs.items()},
        "max_abs_err": main_k2["max_abs_err"],
        "ms": main_k2["kernel_ms"],
        "kernel_ms": main_k2["kernel_ms"],  # as _fit calls it, x rounded once a fit
        "kernel_rounding_ms": main_k2["kernel_rounding_ms"],
        "plain_ms": main_k2["plain_ms"],
        "bound_ms": main_k2["bound_ms"],
        "bound_by": main_k2["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a Lloyd step
        "matmul_ms": main_k2["matmul_ms"],  # the distance product alone
        "recheck_share": main_k2["recheck_share"],
        "device_split_us": main_k2["device_split_us"],
        "shape": {key: main_k2[key] for key in ("chunks", "rows", "d", "k", "precision")},
        "settings": k2,
    }, {
        "name": "K3 kmeans_assign",
        "route": "cuda",
        "source": kmeans_src,
        "replaces": "gsconverter_tpu/ops/kmeans.py:61",
        "launches": sog_runs[SOG_LEVELS[0]]["launches"]["assign"],  # not on the SOG path
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["kernel_ms"],
        "kernel_ms": k3["kernel_ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "fp32_bound_ms": k3["fp32_bound_ms"],  # the products at the FP32 peak
        "library_ms": None,  # no single PyTorch call computes an argmin assign
        "matmul_ms": k3["matmul_ms"],  # the distance product alone
        "recheck_share": k3["recheck_share"],
        "device_split_us": k3["device_split_us"],
        "shape": {"n": K34_N, "d": K34_D, "k": K34_K},
        "label_agree": k3["label_agree"],
        "grid_ties": k3["grid_ties"],
    }, {
        "name": "K4 kmeans_update",
        "route": "cuda",
        "source": update_src,
        "replaces": "gsconverter_tpu/ops/kmeans.py:165",
        "launches": sog_runs[SOG_LEVELS[0]]["launches"]["update"],  # K2's sum stage
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["kernel_ms"],
        "kernel_ms": k4["kernel_ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],  # index_add_
        "skew_ms": k4["skew_ms"],  # every label 0
        "ordered_equal": k4["ordered_equal"],
        "shape": {"n": K34_N, "d": K34_D, "k": K34_K},
        # on the main path K4 sums K2's segments: n = chunks * rows, k =
        # chunks * k, held bit for bit there by K2's sums_ordered_equal
        "main_path_shape": {"n": main_k2["chunks"] * main_k2["rows"], "d": main_k2["d"],
                            "k": main_k2["chunks"] * main_k2["k"]},
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

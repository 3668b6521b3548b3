"""Smoke run of gsconverter_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit; TF32 off;
  2. build: csrc/sor_window.cu (K1), csrc/kmeans.cu (K2's labels, K3),
     csrc/kmeans_update.cu (K4, also K2's sum stage) and csrc/composite.cu
     (K5, K6: tile compositing and its backward), one nvcc each,
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
     1.25x of the CPU's;
  8. the renderer at BASELINE config 4's size (bench.py's render workload):
     a 1M-splat scene minted from seed 0 (SH degree 0) at 1088 x 1920 from
     (0, 0, 5), 60 degrees; auto_budget(band_chunk=128) and its report; the
     banded windowed render (tile_chunk=128, block_m=64) and the gradient of
     sum(img^2) with respect to opacity, with K5's and K6's launches (one
     each per band); forward, forward+gradient and K5/K6 per band timed
     (median of 5 by CUDA events); the band with the largest budget held
     against the plain versions with per-tile exit; K5 and K6 a frame
     against their bounds (counted from each band's alphas), ptxas's lines
     for them; for K6 the share of the frame's (warp, candidate) pairs in
     which some pixel sees the candidate (the ones K6 reduces) and the
     shuffles a pair its sums over pixels take by its source; every
     splat-level gradient against the same render through those plain
     versions, the frame against the plain path (chunk-wide exit) on the card's tensors
     within T_EPS * (max color + max |bg|) + 1e-5 and against the CPU
     plain path by PSNR (>= 60 dB); the 64 x 64 windowed-vs-exact
     crop at full N (>= 35 dB); the scene's .spz round trip (> 30 dB);
     examples/fit_scene.py's scene and 200 steps (fitted PSNR > perturbed
     + 5 dB); 3 timed fit steps at full size with the loss falling.
  9. the device-resident path: config 2's 1M-splat scene read, taken to
     the card with SplatCloud.device() and run through the public filters
     there (bbox, min_opacity=5, density_sensitivity=0.5, sor_intensity=4;
     compaction on the card), each stage's result equal to the host
     chain's, one K1 launch, then Converter.write_processed to .splat, 3DGS
     PLY, .ksplat levels 0-2, .spz and compressed PLY, each file's digest
     against phase 4's (or, where exp or sigmoid on the card rounds an ulp
     away from numpy's, decoded within a step of the host chain's file),
     with the stage times and .splat's tied sort metrics; Converter.run with
     checkpoint_dir and then resumed from it, both .splat files equal to
     phase 4's, with each snapshot's save and load time; the density filter
     on the wide grid (extent / voxel > 1023, 1M points) on the card equal
     to the host path; the SOR grid at the main path's n against the window
     method (>= 99% agreement) and sor_mean_knn_dists on the card against
     the CPU (rel 1e-5); config 3's 3M-splat scene as a device cloud to .sog
     at levels 1 and 10, 11 K2 and K4 launches each, against phase 7's
     host-cloud file (the palette byte-identical, other texels within one
     step).
 10. the multi-device layer (gsconverter_tpu_torch.parallel), after phase
     9's checkpoint runs: (a) a one-rank NCCL group on the card, on whose
     mesh sharded_sor_mask at the main path's n (its sorted positions from
     phase 4) must equal sor_mask's mask, sharded_kmeans_chunked at config
     3's level-1 palette shape (64 x 65,536 x 24, k=1024) must be bit-identical
     to kmeans_chunked, and sharded_kmeans at 1,048,576 x 24, K=4096 must
     launch K3, its labels equal to the plain assign of its centroids on
     every row; (b) two ranks over gloo, both on the one card (collectives
     staged through the host): config 2's 1M scene through Converter.run to
     .splat (byte-identical to phase 4's file), a 200k-splat ply -> sog at
     level 1 (byte-identical to the single-process file) and the same
     chunked fit as (a) (bit-identical to kmeans_chunked), each rank's K1,
     K2, K3 and K4 launches, halo, all-gather and all-reduce bytes and
     walls logged; every path must launch its kernels on every rank, and
     go once through its sharded function (sharded_sor_mask for .splat,
     sharded_kmeans_chunked for .sog and the fit), which must send bytes.
 11. the multi-device renderer and training step on phase 8's 1M-splat
     scene at 1088 x 1920, with phase 8's auto_budget (max_per_tile,
     max_global; no band plan, which belongs to one image), windowed,
     block_m=64: (a) in phase 10 (a)'s one-rank group, sharded_render must
     equal render(bg=0) bit for bit, band_occupancy must be the count of
     splats in front of the camera, sharded_render_tiles (auto budget)
     must reach 35 dB against render, and one make_sharded_train_step
     must match make_train_step from the same parameters (loss rel 1e-5,
     every gradient within 1e-4 of its max |g|); (b) in phase 10 (b)'s
     gloo world, the same on each rank, each image >= 35 dB against the
     rank's single-device render, band_occupancy equal to its count in
     numpy and on both ranks, both ranks' parameters equal after the step,
     and scan, all-to-all, all-gather and all-reduce bytes sent.  Each
     call's K5 / K6 launches (2 / 0 a sharded_render, 1 / 0 a tile render,
     1 / 1 a step) are counted on its first call; its second call is timed
     by CUDA events.

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
# phase 9's wide-grid density scene: points, and the second blob's x offset
# (extent / voxel about 2000 at sensitivity 0.5's voxel of 1.1)
WIDE_N, WIDE_OFFSET = 1_000_000, 2200.0
# config 4 (bench.py:570-572): splats, height, width; the bench's render
# settings; the crop camera's size and field of view
RENDER_N, RENDER_H, RENDER_W = 1_000_000, 1088, 1920
RENDER_CHUNK, RENDER_BM = 128, 64
CROP_SIZE, CROP_FOV = 64, 20.0
FIT_STEPS, FIT_LR = 200, 5e-3  # examples/fit_scene.py
# the full-size training steps: Adam's first steps move every parameter by
# about lr, so lr stays well below the scene's splat scale (exp(-5.5))
TRAIN_LR = 1e-4
# FP32 instructions K5's and K6's function needs, expf counted as 4 (its
# range reduction and scaling; the MUFU op aside), with each term that
# depends only on a pixel's column or only on its row formed once for that
# column or row of the tile.  Every (candidate, pixel) pair a tile walks
# needs t2 = ((2 cb) dx) dy (1), the two adds and the -0.5 of power (3),
# min (1), expf (4), raw, clamp, zero test (4), and 1 - a and the block
# product (2): 15.  A walked candidate also needs, for each of the tile's
# 16 columns, dx, (ca dx) dx and (2 cb) dx: 4; for each of its 16 rows, dy
# and (cc dy) dy: 3; and 2 cb once: 1.  So a walked candidate costs a
# tile 256 * 15 + 16 * 4 + 16 * 3 + 1 = 3953 instructions, 15.44 a pair
# (23 a pair where every term is formed for every pixel).  Where a != 0 a
# pair needs more, K5: its weight (2) and rgb (3): 5; K6: T_i and w (2),
# g . color (3), s and its prefix (3), R_i and d_a with its division (7),
# the live mask (3), d_gauss and d_power (4), the mean and conic terms
# (15), the color terms (3), d_alpha (1), and one add a field for the sums
# over the tile's pixels (9): 50.
WALK_PAIR_OPS, WALK_COLUMN_OPS, WALK_ROW_OPS, WALK_CANDIDATE_OPS = 15, 4, 3, 1
K5_NONZERO_OPS, K6_NONZERO_OPS = 5, 50
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
# phase 10: the backend of its one-rank group, the ranks of its gloo world
# on one card, and that world's ply -> sog scene (points, level)
MD_BACKEND, MD_WORLD, MD_SOG_N, MD_SOG_LEVEL = "nccl", 2, 200_000, 1
# phase 11: the least PSNR of a multi-device image against one device's
# (JAX's own bar), and the bars of a sharded training step against one
# device's: the loss (relative) and every gradient (of its max |g|)
MD_RENDER_DB, MD_LOSS_REL, MD_GRAD_REL = 35.0, 1e-5, 1e-4


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
        # the file and the scene stay for phase 9's device cloud
        r.update(sha256=file_digest(out), path=out)
        runs[level] = r
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


# ------------------------------------------------- phase 9: device clouds


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn):
    """(result, seconds) of ``fn()``, the card synchronised on both sides."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def device_chain_stages():
    """Config 2's filter chain as (name, stage) over the public filters."""
    from gsconverter_tpu_torch.ops import filters

    return (("bbox", lambda c: filters.crop_by_bbox(c, BBOX)),
            ("alpha", lambda c: filters.alpha_filter(c, 5)),
            ("density", lambda c: filters.density_filter(c, sensitivity=0.5)),
            ("sor", lambda c: filters.remove_flyers(c, intensity=4, device=DEVICE)))


# log-scale bound of each main-path file, as tests/test_torch_device_path.py
# STEPS: f32 scales of ``exp`` (.splat, .ksplat level 0) move by an ulp
# (about 1e-7 in log-scale), f16 scales (.ksplat levels 1-2) by an f16 step,
# and 3DGS, .spz and compressed PLY keep or quantize the log-scale itself
LOG_SCALE_STEP = {"splat": 1e-6, "3dgs": 0.0, "ksplat_l0": 1e-6, "ksplat_l1": 1e-3,
                  "ksplat_l2": 1e-3, "spz": 0.0, "compressed_ply": 0.0}


def decoded_within_step(label, fmt, path_a, path_b):
    """Decode two files of ``fmt`` and hold b against a: positions, colours
    and rotations equal, log-scales within ``LOG_SCALE_STEP[label]``, alphas
    within one u8 step (``exp`` and ``sigmoid`` on the card round an ulp
    away from numpy's).  .splat rows whose metrics tie may take another
    order, so its rows are compared in position order."""
    from gsconverter_tpu_torch.formats import get_handler

    h = get_handler(fmt)
    a, b = h.read(path_a), h.read(path_b)
    if a.n != b.n:
        return dict(within=False, n=(a.n, b.n))
    if fmt == "splat":
        a, b = (x.select(np.lexsort(np.asarray(x.pos).T)) for x in (a, b))
    sig = lambda x: 1 / (1 + np.exp(-np.asarray(x, np.float64)))  # noqa: E731
    out = dict(
        pos_equal=bool(np.array_equal(a.pos, b.pos)),
        sh_equal=bool(np.array_equal(a.sh_dc, b.sh_dc) and np.array_equal(a.sh_rest, b.sh_rest)),
        quat_equal=bool(np.array_equal(a.quat, b.quat)),
        log_scale_max_err=float(np.abs(a.log_scale - b.log_scale).max()) if a.n else 0.0,
        alpha_max_err=float(np.abs(sig(a.opacity) - sig(b.opacity)).max()) if a.n else 0.0)
    out["within"] = (out["pos_equal"] and out["sh_equal"] and out["quat_equal"]
                     and out["log_scale_max_err"] <= LOG_SCALE_STEP[label]
                     and out["alpha_max_err"] <= 1 / 255 + 1e-6)
    return out


def splat_tie_groups(cloud):
    """Groups of rows whose .splat sort metric ties exactly, on the card:
    the host's unstable ``np.argsort`` may order such rows otherwise."""
    from gsconverter_tpu_torch.ops import quant

    m = torch.exp(cloud.log_scale.sum(dim=1)) * quant.sigmoid(cloud.opacity)
    sm = torch.sort(m).values
    eq = sm[1:] == sm[:-1]
    starts = eq & torch.cat([torch.ones(1, dtype=torch.bool, device=eq.device), ~eq[:-1]])
    return dict(groups=int(starts.sum()), rows=int(eq.sum() + starts.sum()))


def phase_device_chain(sor, smi, src, runs):
    """Config 2 at 1M splats as a device cloud: read, ``.device()``, the
    public filter chain on the card (compaction on the card), then
    ``Converter.write_processed`` to every main-path format.  Each stage's
    result against the host chain's, each file against phase 4's."""
    from gsconverter_tpu_torch.converter import Converter
    from gsconverter_tpu_torch.formats import get_handler

    source, read_s = timed(lambda: get_handler("3dgs").read(src))
    # the host chain first, each stage's kept positions held for the check
    host, host_pos, host_s = source, {}, {}
    for name, stage in device_chain_stages():
        host, host_s[name] = timed(lambda: stage(host))
        host_pos[name] = host.pos
    # the chain twice: the first call of each torch op on the card loads
    # its kernels (cold), the second is the steady state (warm)
    stages, cold_s, masks_equal = {}, {}, {}
    for run in ("cold", "warm"):
        dev, upload_s = timed(lambda: source.device(DEVICE))
        sor.KERNEL_LAUNCHES = 0
        for name, stage in device_chain_stages():
            dev, stages[name] = timed(lambda: stage(dev))
            masks_equal[name] = bool(np.array_equal(dev.pos.cpu().numpy(), host_pos[name]))
        launches = sor.KERNEL_LAUNCHES
        if launches != 1:
            fail(f"the {run} device chain launched K1 {launches} times, not once")
        if run == "cold":
            cold_s, stages = dict(stages, upload=upload_s), {}
    del source
    chain_s = sum(stages.values())
    files, writes_s = {}, {}
    for label, fmt, opts in (("splat", "splat", {}), ("3dgs", "3dgs", {})) + MAIN_CODECS:
        ref = os.path.join(OUT_DIR, f"dev_host_{label}{EXT[fmt]}")
        out = os.path.join(OUT_DIR, f"dev_{label}{EXT[fmt]}")
        Converter(src, ref, fmt, device=DEVICE).write_processed(host, **opts)
        _, writes_s[label] = timed(
            lambda: Converter(src, out, fmt, device=DEVICE).write_processed(dev, **opts))
        digest = file_digest(out)
        r = dict(identical_to_phase4=digest == runs[label]["sha256"],
                 host_ref_identical_to_phase4=file_digest(ref) == runs[label]["sha256"])
        if not r["identical_to_phase4"]:
            r["check"] = decoded_within_step(label, fmt, ref, out)
        files[label] = r
        os.unlink(out)
        os.unlink(ref)
    r = dict(n=host.n, kept_equal_phase4=dev.n == runs["splat"]["kept"], launches=launches,
             read_s=read_s, upload_s=upload_s, stages_s=stages, cold_stages_s=cold_s,
             host_stages_s=host_s,
             chain_s=chain_s, writes_s=writes_s,
             wall_s=read_s + upload_s + chain_s + sum(writes_s.values()),
             masks_equal_host=masks_equal, splat_tie_groups=splat_tie_groups(dev),
             files=files)
    log(f"[device] config 2 device cloud on {smi}: {json.dumps(r)}")
    if not all(masks_equal.values()) or not r["kept_equal_phase4"]:
        fail(f"the device chain's stages differ from the host chain's: {json.dumps(masks_equal)}")
    for label, f in files.items():
        if not f["host_ref_identical_to_phase4"]:
            fail(f"the host chain's {label} differs from phase 4's file")
        if not f["identical_to_phase4"] and not f["check"]["within"]:
            fail(f"the device cloud's {label} lies beyond its bound: {json.dumps(f)}")
    return r


def phase_checkpoint(sor, smi, src, runs):
    """Config 2 at 1M splats through Converter.run with checkpoint_dir, then
    a resumed run: both .splat files equal phase 4's."""
    from gsconverter_tpu_torch.converter import Converter

    ck = os.path.join(OUT_DIR, "ckpt")
    out = {}
    for run in ("first", "resumed"):
        path = os.path.join(OUT_DIR, f"ckpt_{run}.splat")
        conv = Converter(src, path, "splat", device=DEVICE)
        sor.KERNEL_LAUNCHES = 0
        _, wall = timed(lambda: conv.run(checkpoint_dir=ck, **MAIN_FLAGS))
        rep = conv.timer.report()
        out[run] = dict(wall_s=wall, launches=sor.KERNEL_LAUNCHES,
                        identical_to_phase4=file_digest(path) == runs["splat"]["sha256"],
                        snapshot_s={k: v for k, v in rep.items() if k.startswith("checkpoint")})
        os.unlink(path)
    out["snapshot_mb"] = {s: sum(os.path.getsize(os.path.join(ck, s, f))
                                 for f in os.listdir(os.path.join(ck, s))) / 1e6
                          for s in sorted(os.listdir(ck))}
    shutil.rmtree(ck)
    log(f"[ckpt] config 2 with checkpoint_dir on {smi}: {json.dumps(out)}")
    if out["first"]["launches"] != 1 or out["resumed"]["launches"] != 0:
        fail("the checkpointed runs launched K1 other than once, then not at all")
    if not (out["first"]["identical_to_phase4"] and out["resumed"]["identical_to_phase4"]):
        fail("a checkpointed .splat differs from phase 4's")
    return out


def phase_density_sor(sor, smi, sor_pos):
    """The density filter on the wide grid (extent / voxel > 1023), on the
    card against the host path; the SOR grid at the main path's n against
    the window method on the card and against the CPU."""
    from gsconverter_tpu_torch.ops import density

    rr = np.random.default_rng(5)
    # two N(0, 1.5) blobs, both with voxels above the threshold
    pos = np.concatenate([rr.normal(0, 1.5, (WIDE_N - WIDE_N // 2, 3)),
                          rr.normal(0, 1.5, (WIDE_N // 2, 3)) + [WIDE_OFFSET, 0, 0]]
                         ).astype(np.float32)
    voxel, thresh = density.sensitivity_to_params(0.5)
    host, host_s = timed(lambda: density.density_mask(pos, voxel, thresh, True))
    pos_d = torch.from_numpy(pos).to(DEVICE)
    card, card_s = timed(lambda: density.density_mask(pos_d, voxel, thresh, True))
    wide = dict(n=WIDE_N, extent_over_voxel=float((pos.max(0) - pos.min(0)).max() / voxel),
                equal=bool(np.array_equal(card.cpu().numpy(), host)),
                kept=int(host.sum()), card_ms=card_s * 1e3, host_ms=host_s * 1e3)
    _, wide["card_repeat_ms"] = timed(lambda: density.density_mask(pos_d, voxel, thresh, True))
    wide["card_repeat_ms"] *= 1e3
    log(f"[density] wide grid on {smi}: {json.dumps(wide)}")
    if not wide["equal"] or wide["extent_over_voxel"] <= 1023:
        fail(f"the wide-grid density mask on the card differs from the host path's: "
             f"{json.dumps(wide)}")

    n = sor_pos.shape[0]
    grid, grid_s = timed(lambda: sor.sor_mask(sor_pos, 25, 10.5, method="grid"))
    window, window_s = timed(lambda: sor.sor_mask(sor_pos, 25, 10.5))
    md_card, md_card_s = timed(lambda: sor.sor_mean_knn_dists(sor_pos, 25))
    md_cpu, md_cpu_s = timed(lambda: sor.sor_mean_knn_dists(sor_pos.cpu(), 25))
    rel = ((md_card.cpu() - md_cpu).abs() / md_cpu.clamp_min(1e-12)).max()
    g = dict(n=n, grid_vs_window_agree=float((grid == window).float().mean()),
             grid_kept=int(grid.sum()), window_kept=int(window.sum()),
             grid_ms=grid_s * 1e3, window_ms=window_s * 1e3,
             md_card_ms=md_card_s * 1e3, md_cpu_ms=md_cpu_s * 1e3,
             md_max_rel_card_vs_cpu=float(rel))
    log(f"[sor] grid method at the main path's n on {smi}: {json.dumps(g)}")
    if g["grid_vs_window_agree"] < 0.99 or g["md_max_rel_card_vs_cpu"] > 1e-5:
        fail(f"the SOR grid disagrees: {json.dumps(g)}")
    return wide, g


def compare_sog(path_a, path_b):
    """Two .sog files: the entries that are byte-identical, and for the
    others the largest texel difference (positions as u16) and meta.json's
    other keys."""
    from gsconverter_tpu_torch.formats import sog

    za, zb = zipfile.ZipFile(path_a), zipfile.ZipFile(path_b)
    names = [i.filename for i in za.infolist()]
    ma, mb = json.loads(za.read("meta.json")), json.loads(zb.read("meta.json"))
    n = ma["count"]
    differ = [x for x in names if za.read(x) != zb.read(x)]

    def plane(z, name):
        return sog._read_webp_flat(z, name, n).astype(np.int64)

    out = dict(identical=[x for x in names if x not in differ],
               names_equal=names == [i.filename for i in zb.infolist()],
               meta_other_equal=all(ma[k] == mb[k] for k in ma if k != "means"))
    texel = {}
    for name in differ:
        if name == "meta.json":
            continue
        if name == "shN_centroids.webp":
            texel[name] = -1  # another palette: never within the bound
            continue
        if name.startswith("means_"):
            a = plane(za, "means_l.webp")[:, :3] | (plane(za, "means_u.webp")[:, :3] << 8)
            b = plane(zb, "means_l.webp")[:, :3] | (plane(zb, "means_u.webp")[:, :3] << 8)
        else:
            a, b = plane(za, name), plane(zb, name)
        texel[name] = int(np.abs(a - b).max())
    out["max_texel_diff"] = texel
    out["means_bounds_rel"] = max(
        float(np.max(np.abs(np.array(ma["means"][k]) - np.array(mb["means"][k]))
                     / np.maximum(np.abs(np.array(ma["means"][k])), 1e-30)))
        for k in ("mins", "maxs"))
    out["within"] = (out["names_equal"] and out["meta_other_equal"]
                     and all(v <= 1 for v in texel.values())
                     and out["means_bounds_rel"] <= 2.4e-7
                     and {"shN_centroids.webp", "shN_labels.webp"} <= set(out["identical"]))
    return out


def phase_device_sog(km, smi, sog_runs):
    """Config 3: the 3M-splat scene as a device cloud to .sog at levels 1
    and 10, each file against phase 7's host-cloud file."""
    from gsconverter_tpu_torch import config
    from gsconverter_tpu_torch.converter import Converter
    from gsconverter_tpu_torch.formats import get_handler

    src = os.path.join(OUT_DIR, "scene_sog.ply")
    host, read_s = timed(lambda: get_handler("3dgs").read(src))
    dev, upload_s = timed(lambda: host.device(DEVICE))
    del host
    runs = {}
    for level in SOG_LEVELS:
        out = os.path.join(OUT_DIR, f"dev_{level}.sog")
        buf = io.StringIO()
        km.LAUNCHES.update(dict.fromkeys(km.LAUNCHES, 0))
        prev, config.TIMING = config.TIMING, True
        try:
            with contextlib.redirect_stdout(buf):
                _, wall = timed(lambda: Converter(src, out, "sog", device=DEVICE)
                                .write_processed(dev, compression_level=level))
        finally:
            config.TIMING = prev
        launches = dict(km.LAUNCHES)
        r = dict(level=level, read_s=read_s, upload_s=upload_s, write_s=wall,
                 launches=launches,
                 stages_ms={k: v for k, v in sog_stage_times(buf.getvalue()).items()
                            if k.startswith("sog.")},
                 identical_to_phase7=file_digest(out) == sog_runs[level]["sha256"],
                 check=compare_sog(sog_runs[level]["path"], out))
        log(f"[device] config 3 device cloud -> sog level {level} on {smi}: {json.dumps(r)}")
        if launches["lloyd"] != 11 or launches["update"] != 11:
            fail(f"device sog level {level} launched K2 {launches['lloyd']} and K4 "
                 f"{launches['update']} times, not 11 each")
        if not r["identical_to_phase7"] and not r["check"]["within"]:
            fail(f"device sog level {level} lies beyond its bound: {json.dumps(r['check'])}")
        os.unlink(out)
        os.unlink(sog_runs[level]["path"])
        runs[level] = r
    os.unlink(src)
    return runs


# ------------------------------------------------------------ config 4


def cuda_median_ms(fn, reps=5, warmup=1):
    """Median of ``reps`` single-call times by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_profile(fn, top=10):
    """One call of ``fn`` under torch.profiler after a warm-up: its wall
    time (host clock, synchronised), the device time summed over its
    kernels, the busy share (device / wall) and the ``top`` kernels and
    copies by self device time (us)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue  # an operator's row repeats its kernels' time
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            rows.append((evt.key[:60], float(us), int(evt.count)))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return dict(wall_ms=wall_us / 1e3, device_ms=busy / 1e3, busy_share=busy / wall_us,
                top=[{"name": n, "us": us, "calls": c} for n, us, c in rows[:top]])


def render_bench_scene(n, seed=0):
    """bench.py's render scene (:306-320) as a host cloud: N(0, 1)
    positions, SH degree 0, logit opacity N(-1, 1), log-scale N(-5.5, 0.3),
    identity rotations."""
    from gsconverter_tpu_torch.cloud import SplatCloud

    rr = np.random.default_rng(seed)
    return SplatCloud(
        pos=rr.normal(0, 1.0, (n, 3)).astype(np.float32),
        sh_dc=rr.normal(0, 0.5, (n, 3)).astype(np.float32),
        sh_rest=np.zeros((n, 3, 15), np.float32),
        opacity=rr.normal(-1, 1, (n,)).astype(np.float32),
        log_scale=rr.normal(-5.5, 0.3, (n, 3)).astype(np.float32),
        quat=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        normal=np.zeros((n, 3), np.float32),
        active_sh_degree=0,
    )


def fit_demo_scene(n=600, seed=3):
    """examples/fit_scene.py's scene: a colored ring and a core cluster."""
    from gsconverter_tpu_torch.cloud import SplatCloud

    r = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n // 2, endpoint=False)
    ring = np.stack([np.cos(t) * 1.5, np.sin(t) * 1.5, np.zeros_like(t)], 1)
    core = r.normal(0, 0.4, (n - n // 2, 3))
    hue = np.concatenate([t / (2 * np.pi), r.uniform(0, 1, n - n // 2)])
    sh_dc = np.stack([np.cos(hue * 2 * np.pi), np.cos((hue + 1 / 3) * 2 * np.pi),
                      np.cos((hue + 2 / 3) * 2 * np.pi)], 1).astype(np.float32)
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return SplatCloud(
        pos=np.concatenate([ring, core]).astype(np.float32), sh_dc=sh_dc,
        sh_rest=np.zeros((n, 3, 15), np.float32),
        opacity=np.full((n,), 1.5, np.float32),
        log_scale=np.full((n, 3), -2.5, np.float32), quat=quat,
        normal=np.zeros((n, 3), np.float32), active_sh_degree=0)


class composite_spy:
    """The arguments of every K5 and K6 launch while active (references)."""

    def __init__(self, rz):
        self.rz, self.fwd, self.bwd = rz, [], []

    def __enter__(self):
        self.orig = fwd, bwd = self.rz._composite_fwd_kernel, self.rz._composite_bwd_kernel

        def spy_fwd(*args):
            self.fwd.append(args)
            return fwd(*args)

        def spy_bwd(*args):
            self.bwd.append(args)
            return bwd(*args)

        self.rz._composite_fwd_kernel, self.rz._composite_bwd_kernel = spy_fwd, spy_bwd
        return self

    def __exit__(self, *exc):
        self.rz._composite_fwd_kernel, self.rz._composite_bwd_kernel = self.orig
        return False


class plain_composite:
    """Route K5's and K6's wrappers through their plain versions with
    per-tile exit (the kernels' semantics) while active."""

    def __init__(self, rz):
        self.rz = rz

    def __enter__(self):
        rz = self.rz
        self.orig = rz._composite_fwd_kernel, rz._composite_bwd_kernel

        def fwd(bm, g, a, o, c, bg):
            return rz._composite_fwd_ref(bm, g, a, o, c, bg, per_tile=True)

        def bwd(*args):
            d_geo, d_al, d_bg = rz._composite_bwd_ref(*args)
            return d_geo, d_al, d_bg[None, :]

        rz._composite_fwd_kernel, rz._composite_bwd_kernel = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.rz._composite_fwd_kernel, self.rz._composite_bwd_kernel = self.orig
        return False


class plain_path:
    """The CPU path's compositing on the card's own tensors while active:
    JAX's chunks of ``tile_chunk`` tiles (pads included) with their
    chunk-wide exit, through the plain forward.  Projection and binning
    are the card's, so every alpha is bit for bit the kernels'; only the
    exit rule differs."""

    def __init__(self, rz):
        self.rz = rz

    def __enter__(self):
        rz = self.rz
        self.orig = groups, _ = rz._launch_groups, rz._composite

        def chunk_groups(n_tiles, tile_chunk, on_card, *args):
            return groups(n_tiles, tile_chunk, False, *args)

        def chunk_composite(bm, g, a, o, c, bg, per_tile=True):
            return rz._composite_fwd_ref(bm, g, a, o, c, bg, per_tile=False)[0]

        rz._launch_groups, rz._composite = chunk_groups, chunk_composite
        return self

    def __exit__(self, *exc):
        self.rz._launch_groups, self.rz._composite = self.orig
        return False


def composite_bound_ms(kernel, counts, n_done, bm, nonzero):
    """Least time for K5's or K6's function on one band: the FP32
    instructions it needs over their issue rate, or its bytes (the walked
    window rows, 36 B each, read once; the per-pixel outputs and saved
    transmittances; K6 also its gradient rows) over the memory rate.  The
    tiles walk the sum over tiles of min(count, n_done * BM) candidates,
    each with its 256 pairs, 16 columns and 16 rows (WALK_*_OPS), and
    K5_NONZERO_OPS or K6_NONZERO_OPS more for each of the ``nonzero``
    pairs with a != 0."""
    c = counts.numel()
    rows = int(torch.minimum(counts.long(), n_done.long() * bm).sum())
    blocks = int(n_done.long().sum())
    walk = (256 * WALK_PAIR_OPS + 16 * WALK_COLUMN_OPS + 16 * WALK_ROW_OPS
            + WALK_CANDIDATE_OPS)
    if kernel == "K5":
        ops = rows * walk + nonzero * K5_NONZERO_OPS
        nbytes = rows * 36 + c * 256 * 16 + blocks * 256 * 4 + c * 8
    else:
        ops = rows * walk + nonzero * K6_NONZERO_OPS
        nbytes = rows * 72 + c * 256 * 16 + blocks * 256 * 4 + c * 16
    t_ops, t_bytes = ops / FP32_INSTR_RATE, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            rows * 256)


def compare_band(rz, fwd_args, grgb):
    """K5 and K6 against their plain versions with per-tile exit on one
    band: the image within 2e-5, per-entry gradients within 1e-4 * max|g|
    of each field; a tile whose exit decision differs is reported and
    allowed T_EPS * (max color + max |bg|)."""
    bm, geo, al, origin, counts, bg = fwd_args
    k = rz._composite_fwd_kernel(*fwd_args)
    torch.cuda.synchronize()
    p = rz._composite_fwd_ref(bm, geo, al, origin, counts, bg, per_tile=True)
    flip = k[3] != p[3]
    same = ~flip
    err = (k[0] - p[0]).abs().amax((1, 2))
    allow = rz.T_EPS * (float(geo[..., 5:8].max()) + float(bg.abs().max()))
    out = dict(tiles=counts.numel(), m=geo.shape[1], bm=bm, exit_flips=int(flip.sum()),
               rgb_max_abs_err=float(err[same].max()),
               rgb_flip_max_abs_err=float(err[flip].max()) if flip.any() else 0.0,
               flip_allowance=allow,
               n_done_equal=bool(torch.equal(k[3], p[3])))
    dk = rz._composite_bwd_kernel(bm, geo, al, origin, bg, k[1], k[2], k[3], grgb)
    torch.cuda.synchronize()
    dp = rz._composite_bwd_ref(bm, geo, al, origin, bg, k[1], k[2], k[3], grgb)
    rows = same[:, None].expand(-1, geo.shape[1])
    cols = {"mean": slice(0, 2), "conic": slice(2, 5), "color": slice(5, 8)}
    fields = {f: dk[0][..., sl] - dp[0][..., sl] for f, sl in cols.items()}
    fields["alpha"] = dk[1] - dp[1]
    scale = {f: dp[0][..., sl] for f, sl in cols.items()}
    scale["alpha"] = dp[1]
    out["grad_rel_err"] = {
        f: float(d[rows].abs().max() / scale[f][rows].abs().max().clamp_min(1e-30))
        for f, d in fields.items()}
    out["grad_max_abs_err"] = max(float(d[rows].abs().max()) for d in fields.values())
    out["d_bg_rel_err"] = float((dk[2].sum(0) - dp[2]).abs().max()
                                / dp[2].abs().max().clamp_min(1e-30))
    out["repeat_identical"] = bool(
        torch.equal(k[0], rz._composite_fwd_kernel(*fwd_args)[0])
        and torch.equal(dk[0], rz._composite_bwd_kernel(bm, geo, al, origin, bg, k[1], k[2],
                                                        k[3], grgb)[0]))
    if out["rgb_max_abs_err"] > 2e-5 or out["rgb_flip_max_abs_err"] > allow + 2e-5 \
            or max(out["grad_rel_err"].values()) > 1e-4 or out["d_bg_rel_err"] > 1e-4 \
            or not out["repeat_identical"]:
        fail(f"K5/K6 disagree with their plain versions on a band: {json.dumps(out)}")
    return out


def alpha_counts(rz, bm, geo, al, origin, n_done):
    """Over the blocks a band's tiles composited, by the plain version's
    ``_block_alpha`` on the band's own tensors: the (candidate, pixel) pairs
    with a != 0, and for each (tile, block, warp) its live candidates, those
    that some pixel of the warp sees (the ones K6 reduces)."""
    c_sz, m = al.shape
    nb = m // bm
    gx, gy = rz._pixel_grid(origin)
    geo_b, al_b = geo.reshape(c_sz, nb, bm, rz.GEO), al.reshape(c_sz, nb, bm)
    nonzero, live = 0, [torch.zeros(0, dtype=torch.long, device=al.device)]
    for b in range(int(n_done.max()) if c_sz else 0):
        on = n_done > b
        blk = geo_b[on, b]
        a = rz._block_alpha(blk[..., 0:2], blk[..., 2:5], al_b[on, b], gx[on], gy[on])[0]
        seen = a != 0
        nonzero += int(seen.sum())
        warps = seen.reshape(a.shape[0], bm, rz.PIXELS // 32, 32).any(-1)
        live.append(warps.sum(1).flatten())
    return nonzero, torch.cat(live)


def k6_shuffles(live):
    """The shuffles K6's warps spend on their sums over pixels, counted from
    ``csrc/composite.cu``, for blocks in which they see ``live``
    candidates: 81 a group of 8 while more than 4 are left, then 54 for
    the last 3-4 or 45 for the last 1-2."""
    full = (live + 3) // 8
    rest = live - 8 * full
    return int((81 * full + 54 * (rest > 2) + 45 * ((rest > 0) & (rest <= 2))).sum())


def queued_ms(fn, reps=10, spin_cycles=20_000_000):
    """Mean device time (ms) of a call of ``fn``, by CUDA events around
    ``reps`` calls queued behind a spin of the card (about 10 ms), so that
    they run back to back: without the host's launch overhead, which CUDA
    events around a single call include.  The start event must still be
    pending once the last call is queued, else the card may have idled
    between calls: then the spin is doubled and the timing taken again, up
    to three times.  (Per-kernel sums of torch.profiler with only CUDA
    activity missed launches late in a long run of this script.)"""
    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(reps):
            fn()
        queued_behind_spin = not start.query()
        end.record()
        torch.cuda.synchronize()
        if queued_behind_spin:
            return start.elapsed_time(end) / reps
        spin_cycles *= 2
    fail(f"queued_ms: the host did not queue {reps} calls within a spin of "
         f"{spin_cycles // 2} cycles")


def time_bands(rz, fwd_calls, bwd_calls):
    """Per band: K5 and K6 per launch (median of 5 by CUDA events, and
    their device time queued back to back, ``queued_ms``), their plain
    versions (one call) and bounds; K6 is timed on the cotangent the main
    path gave.
    Also the band's pairs with a != 0, its (warp, candidate) pairs and
    those in which the warp sees the candidate, and the shuffles K6's
    source spends on them."""
    bands = []
    for args in fwd_calls:
        bm, geo, al, origin, counts, bg = args
        k = rz._composite_fwd_kernel(*args)
        bargs = next(b for b in bwd_calls if b[1].shape == geo.shape)
        grgb = bargs[-1]
        nonzero, live = alpha_counts(rz, bm, geo, al, origin, k[3])
        b5, by5, pairs = composite_bound_ms("K5", counts, k[3], bm, nonzero)
        b6, by6, _ = composite_bound_ms("K6", counts, k[3], bm, nonzero)
        saved = (bm, geo, al, origin, bg, k[1], k[2], k[3], grgb)
        bands.append(dict(
            tiles=counts.numel(), m=geo.shape[1], walked_pairs=pairs,
            nonzero_pairs=nonzero, warp_candidate_pairs=live.numel() * bm,
            warp_candidate_live=int(live.sum()), k6_shuffles=k6_shuffles(live),
            k5_ms=cuda_median_ms(lambda: rz._composite_fwd_kernel(*args)),
            k6_ms=cuda_median_ms(lambda: rz._composite_bwd_kernel(*saved)),
            k5_device_ms=queued_ms(lambda: rz._composite_fwd_kernel(*args)),
            k6_device_ms=queued_ms(lambda: rz._composite_bwd_kernel(*saved)),
            k5_plain_ms=cuda_median_ms(
                lambda: rz._composite_fwd_ref(bm, geo, al, origin, counts, bg, True),
                reps=1, warmup=0),
            k6_plain_ms=cuda_median_ms(lambda: rz._composite_bwd_ref(*saved), reps=1,
                                       warmup=0),
            k5_bound_ms=b5, k5_bound_by=by5, k6_bound_ms=b6, k6_bound_by=by6))
    return bands


def ptxas_lines(log_text, kernel):
    """ptxas's -v lines (registers, shared memory, spills) for the entry
    function whose name holds ``kernel``."""
    lines, on = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def bench_render(rz, cloud):
    """Config 4's camera, its budget (auto_budget) and the bench's render
    settings for ``cloud``."""
    cam = rz.Camera.look_at(eye=[0, 0, 5.0], target=[0, 0, 0], fov_deg=60.0,
                            width=RENDER_W, height=RENDER_H)
    budget = rz.auto_budget(cloud, cam, band_chunk=RENDER_CHUNK)
    kw = dict(binning="windowed", max_global=budget["max_global"], tile_chunk=RENDER_CHUNK,
              block_m=RENDER_BM, tile_order=budget["tile_order"],
              band_plan=budget["band_plan"])
    return cam, budget, kw


def bench_train_step(train, cloud, cam, kw):
    """Config 4's Adam step, from a perturbed copy of ``cloud`` towards a
    target image given to each call."""
    base = cloud.replace(sh_dc=cloud.sh_dc + 0.2, opacity=cloud.opacity - 0.3)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in train.params_of(base).items()}
    opt = torch.optim.Adam(list(params.values()), lr=TRAIN_LR, betas=(0.9, 0.999), eps=1e-8)
    return train.make_train_step(base, cam, opt, params, **kw)


def phase_render(smi):
    """BASELINE config 4 at full size on the card: the bench's render
    workload, its checks, and the training step."""
    from gsconverter_tpu_torch.formats import get_handler
    from gsconverter_tpu_torch.render import rasterizer as rz
    from gsconverter_tpu_torch.render import train

    out = {}
    t0 = time.perf_counter()
    host = render_bench_scene(RENDER_N)
    cloud = host.to_device(DEVICE)
    torch.cuda.synchronize()
    log(f"[render] minted {RENDER_N}-splat scene in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cam, budget, kw = bench_render(rz, cloud)
    out["auto_budget_s"] = time.perf_counter() - t0
    out["budget"] = {k: v for k, v in budget.items() if k not in ("tile_order", "band_plan")}
    out["band_plan"] = [list(b) for b in budget["band_plan"]]
    log(f"[render] budget on {smi}: {json.dumps(out['budget'])}; bands {out['band_plan']}")
    n_bands = len(budget["band_plan"])

    # the main path: one forward and the gradient of sum(img^2) w.r.t. opacity
    op = cloud.opacity.clone().requires_grad_(True)
    rz.LAUNCHES.update(dict.fromkeys(rz.LAUNCHES, 0))
    with composite_spy(rz) as spy:
        img = rz.render(cloud.replace(opacity=op), cam, **kw)
        torch.sum(img * img).backward()
        torch.cuda.synchronize()
    launches = dict(rz.LAUNCHES)
    out["launches"] = launches
    if launches != {"composite_fwd": n_bands, "composite_bwd": n_bands}:
        fail(f"the render launched {launches}, not K5 and K6 once for each of "
             f"{n_bands} bands")
    img = img.detach()
    if tuple(img.shape) != (RENDER_H, RENDER_W, 3) or not bool(torch.isfinite(img).all()) \
            or not bool(torch.isfinite(op.grad).all()) or float(op.grad.abs().max()) <= 0:
        fail("the render gave a non-finite or empty image or gradient")
    out["img_mean"] = float(img.mean())

    # times: forward, forward + gradient, median of 5 after a warm-up
    def fwd():
        with torch.no_grad():
            return rz.render(cloud, cam, **kw)

    def grad():
        op.grad = None
        im = rz.render(cloud.replace(opacity=op), cam, **kw)
        torch.sum(im * im).backward()

    out["fwd_ms"] = cuda_median_ms(fwd)
    out["fwd_grad_ms"] = cuda_median_ms(grad)
    out["fwd_profile"] = device_profile(fwd)
    out["fwd_grad_profile"] = device_profile(grad)
    # the profiler's host overhead stretches its own wall: the busy share
    # of a timed call is the kernels' device time over the timed median
    out["fwd_busy_share"] = out["fwd_profile"]["device_ms"] / out["fwd_ms"]
    out["fwd_grad_busy_share"] = out["fwd_grad_profile"]["device_ms"] / out["fwd_grad_ms"]
    log(f"[render] {RENDER_N} splats at {RENDER_H}x{RENDER_W} on {smi}: "
        f"fwd {out['fwd_ms']:.3f} ms, fwd+grad {out['fwd_grad_ms']:.3f} ms, "
        f"launches {json.dumps(launches)}")

    # K5 and K6 on every band of the frame, and the largest band held
    # against their plain versions
    with torch.no_grad():
        out["bands"] = time_bands(rz, spy.fwd, spy.bwd)
        big = max(spy.fwd, key=lambda a: a[1].shape[1])
        grgb = next(b for b in spy.bwd if b[1].shape == big[1].shape)[-1]
        out["band_check"] = compare_band(rz, big, grgb)
    log(f"[render] bands: {json.dumps(out['bands'])}")
    for key in ("fwd_profile", "fwd_grad_profile"):
        log(f"[render] {key} on {smi}: {json.dumps(out[key])}")
    log(f"[render] largest band vs plain: {json.dumps(out['band_check'])}")
    # K5 and K6 alone: per band and a frame against their bounds, their
    # ptxas lines;
    # for K6 also the share of (warp, candidate) pairs in which the warp
    # sees the candidate (the ones K6 reduces), and the shuffles its source
    # spends on them
    from gsconverter_tpu_torch.utils import cuda_build

    bands = out["bands"]

    def alone(key, entry):
        ms = [b[f"{key}_ms"] for b in bands]
        bound = sum(b[f"{key}_bound_ms"] for b in bands)
        return dict(
            per_band_ms=ms, frame_ms=sum(ms),
            device_per_band_ms=[b[f"{key}_device_ms"] for b in bands],
            device_frame_ms=sum(b[f"{key}_device_ms"] for b in bands), bound_ms=bound,
            share_of_bound=bound / sum(ms),
            ptxas=ptxas_lines(cuda_build.BUILD_LOG.get("composite", ""), entry) or
            ["not in this process's build log (a cached library)"])

    out["k5"] = alone("k5", "composite_fwd_kernel")
    log(f"[render] K5 on {smi}: {json.dumps(out['k5'])}")
    n_live = sum(b["warp_candidate_live"] for b in bands)
    n_shfl = sum(b["k6_shuffles"] for b in bands)
    out["k6"] = dict(
        alone("k6", "composite_bwd_kernel"),
        nonzero_share=sum(b["nonzero_pairs"] for b in bands)
        / sum(b["walked_pairs"] for b in bands),
        warp_candidate_live_share=n_live / sum(b["warp_candidate_pairs"] for b in bands),
        # counted from the source (k6_shuffles), not measured
        source_shuffles_per_reduced_pair=n_shfl / max(n_live, 1),
        source_shuffles_per_walked_pair=n_shfl / sum(b["warp_candidate_pairs"]
                                                     for b in bands))
    log(f"[render] K6 on {smi}: {json.dumps(out['k6'])}")
    del spy, big, grgb

    # every splat-level gradient, kernels against the plain versions
    names = ("pos", "sh_dc", "opacity", "log_scale", "quat")

    def all_grads():
        ps = {k: getattr(cloud, k).clone().requires_grad_(True) for k in names}
        im = rz.render(cloud.replace(**ps), cam, **kw)
        torch.sum(im * im).backward()
        return im.detach(), {k: v.grad for k, v in ps.items()}

    img_k, g_k = all_grads()
    with plain_composite(rz):
        img_p, g_p = all_grads()
    splat = {k: float((g_k[k] - g_p[k]).abs().max() / g_p[k].abs().max().clamp_min(1e-30))
             for k in names}
    out["splat_grad_rel_err"] = splat
    out["frame_vs_plain_per_tile_max_abs"] = float((img_k - img_p).abs().max())
    log(f"[render] splat-level gradients vs the plain versions: {json.dumps(splat)}")
    if max(splat.values()) > 2e-4:
        fail(f"splat-level gradients differ from the plain versions': {json.dumps(splat)}")
    del g_k, g_p, img_k, img_p

    # the frame against the plain path (JAX's chunk-wide exit), on the
    # card's tensors: the two differ only where a tile exits before its
    # chunk, by at most T_EPS * (max color + max |bg|)
    max_color = float(np.clip(0.5 + 0.28209479177387814 * host.sh_dc, 0, None).max())
    allow = rz.T_EPS * max_color + 1e-5
    with torch.no_grad(), plain_path(rz):
        img_plain = rz.render(cloud, cam, **kw)
    out["frame_vs_plain_path_max_abs"] = float((img - img_plain).abs().max())
    out["frame_vs_plain_path_allowance"] = allow
    # and the CPU plain path on the host cloud: CPU and CUDA exp and
    # projection roundings differ by ulps, and where raw alpha sits at the
    # 1/255 step that flips a contribution of about 0.004, so the CPU frame
    # is held by PSNR
    t0 = time.perf_counter()
    with torch.no_grad():
        img_cpu = rz.render(host, cam, device="cpu", **kw)
    out["cpu_plain_frame_s"] = time.perf_counter() - t0
    out["frame_vs_cpu_max_abs"] = float((img.cpu() - img_cpu).abs().max())
    out["frame_vs_cpu_psnr_db"] = float(rz.psnr(img.cpu(), img_cpu))
    log(f"[render] frame vs the plain path on the card: max abs "
        f"{out['frame_vs_plain_path_max_abs']:.3g} (allowed {allow:.3g}); vs the CPU plain "
        f"path: max abs {out['frame_vs_cpu_max_abs']:.3g}, "
        f"{out['frame_vs_cpu_psnr_db']:.2f} dB, CPU render {out['cpu_plain_frame_s']:.1f} s")
    if out["frame_vs_plain_path_max_abs"] > allow:
        fail("the card's frame differs from the plain path beyond T_EPS * max color")
    if out["frame_vs_cpu_psnr_db"] < 60.0:
        fail("the card's frame differs from the CPU plain path by more than 60 dB PSNR")
    del img_cpu, img_plain

    # windowed vs exact crop at full N
    crop = rz.Camera.look_at(eye=[0, 0, 5.0], target=[0, 0, 0], fov_deg=CROP_FOV,
                             width=CROP_SIZE, height=CROP_SIZE)
    cb = rz.auto_budget(cloud, crop, cap=16384)
    with torch.no_grad():
        img_w = rz.render(cloud, crop, binning="windowed", max_per_tile=cb["max_per_tile"],
                          max_global=cb["max_global"], tile_chunk=16)
        img_e = rz.render(cloud, crop, binning="exact", max_per_tile=cb["max_per_tile"],
                          tile_chunk=16)
    out["crop_psnr_db"] = float(rz.psnr(img_w, img_e))  # 120 dB: mse below 1e-12
    out["crop_max_abs"] = float((img_w - img_e).abs().max())
    out["crop_budget"] = {k: v for k, v in cb.items() if k not in ("tile_order", "band_plan")}
    log(f"[render] crop {CROP_SIZE}x{CROP_SIZE} windowed vs exact: "
        f"{out['crop_psnr_db']:.2f} dB (max abs {out['crop_max_abs']:.3g}), "
        f"budget {json.dumps(out['crop_budget'])}")
    if out["crop_psnr_db"] < 35.0:
        fail(f"crop PSNR {out['crop_psnr_db']:.2f} dB is below 35")

    # the .spz round trip, checked by rendered PSNR
    path = os.path.join(OUT_DIR, "render_scene.spz")
    get_handler("spz").write(host, path)
    back = get_handler("spz").read(path)
    os.unlink(path)
    with torch.no_grad():
        img_b = rz.render(back.to_device(DEVICE), cam, **kw)
    out["spz_psnr_db"] = float(rz.psnr(img, img_b))
    log(f"[render] .spz round trip: {out['spz_psnr_db']:.2f} dB")
    if out["spz_psnr_db"] <= 30.0:
        fail(f".spz round trip renders at {out['spz_psnr_db']:.2f} dB, not above 30")
    del back, img_b

    # examples/fit_scene.py: perturb and recover
    demo = fit_demo_scene()
    dcam = rz.Camera.look_at(eye=(0, -1.5, -5), target=(0, 0, 0), width=256, height=256)
    target = rz.render(demo, dcam, max_per_tile=256, device=DEVICE)
    r = np.random.default_rng(0)
    perturbed = demo.replace(
        pos=demo.pos + r.normal(0, 0.05, demo.pos.shape).astype(np.float32),
        sh_dc=demo.sh_dc * 0.5, opacity=demo.opacity - 1.0)
    p0 = float(rz.psnr(rz.render(perturbed, dcam, max_per_tile=256, device=DEVICE), target))
    t0 = time.perf_counter()
    fitted, losses = train.fit(perturbed, dcam, target, steps=FIT_STEPS, lr=FIT_LR,
                               max_per_tile=256, device=DEVICE)
    fit_s = time.perf_counter() - t0
    p1 = float(rz.psnr(rz.render(fitted, dcam, max_per_tile=256), target))
    out["fit_demo"] = dict(psnr_perturbed_db=p0, psnr_fitted_db=p1, steps=FIT_STEPS,
                           loss_first=losses[0], loss_last=losses[-1], wall_s=fit_s)
    log(f"[render] fit demo: {json.dumps(out['fit_demo'])}")
    if not p1 > p0 + 5.0:
        fail(f"the fit demo reached {p1:.2f} dB from {p0:.2f} dB, not +5 dB")

    # three timed training steps at full size
    step = bench_train_step(train, cloud, cam, kw)
    step_ms, step_loss = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(img))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_loss.append(loss)
    out["train_steps"] = dict(ms=step_ms, loss=step_loss)
    out["train_step_profile"] = device_profile(lambda: step(img))
    out["train_step_busy_share"] = out["train_step_profile"]["device_ms"] / float(
        np.median(step_ms))
    log(f"[render] full-size train steps on {smi}: {json.dumps(out['train_steps'])}")
    log(f"[render] train_step_profile on {smi}: {json.dumps(out['train_step_profile'])}")
    if not step_loss[-1] < step_loss[0]:
        fail(f"the full-size training loss did not fall: {step_loss}")
    return out


# ---------------------------------------- phase 10: the multi-device layer


def kernel_counts():
    """K1-K4's launch counts (K2's sum stage also counts under K4)."""
    from gsconverter_tpu_torch.ops import kmeans as km
    from gsconverter_tpu_torch.ops import sor

    return dict(k1=sor.KERNEL_LAUNCHES, k2=km.LAUNCHES["lloyd"],
                k3=km.LAUNCHES["assign"], k4=km.LAUNCHES["update"])


def reset_counts():
    """Every kernel count and the collectives' byte counts to 0."""
    from gsconverter_tpu_torch.ops import kmeans as km
    from gsconverter_tpu_torch.ops import sor
    from gsconverter_tpu_torch.parallel import distributed as pd

    sor.KERNEL_LAUNCHES = 0
    km.LAUNCHES.update(dict.fromkeys(km.LAUNCHES, 0))
    pd.BYTES.update(dict.fromkeys(pd.BYTES, 0))


def tensor_digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def md_chunked_input():
    """Config 3's palette input at level 1: (rows, chunks, k per chunk)."""
    return sog_rows(SOG_N, SOG_D, seed=11), SOG_CHUNKS, K2_KS[0]


def phase_multidevice_one_rank(sor, km, smi, sor_pos, render_kw):
    """Phase 10 (a): a one-rank MD_BACKEND (NCCL) group on the card; the
    sharded SOR, chunked K-Means and K-Means on its mesh against the
    single-device calls; then phase 11 (a) in the same group.  Returns the
    results, the digests of the single-device chunked fit and phase 11
    (a)'s results."""
    import torch.distributed as dist
    from gsconverter_tpu_torch.ops.padding import PAD_POS, next_pow2, pad_rows
    from gsconverter_tpu_torch.parallel import distributed as pd
    from gsconverter_tpu_torch.parallel.mesh import make_mesh

    rendezvous = os.path.join(OUT_DIR, "md_one_rank")
    dist.init_process_group(MD_BACKEND, init_method=f"file://{rendezvous}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(device=None if MD_BACKEND == "nccl" else DEVICE)
        out = dict(backend=mesh.backend, size=mesh.size, device=str(mesh.device))
        k, sigma = sor.intensity_to_params(MAIN_FLAGS["sor_intensity"])
        reset_counts()
        # the first collective of an NCCL group also sets up its communicator
        mask, wall = timed(lambda: pd.sharded_sor_mask(sor_pos, mesh, k=k, sigma=sigma))
        out["sor"] = dict(n=sor_pos.shape[0], wall_s=wall, launches=kernel_counts(),
                          bytes=dict(pd.BYTES), kept=int(mask.sum()))
        _, out["sor"]["second_wall_s"] = timed(
            lambda: pd.sharded_sor_mask(sor_pos, mesh, k=k, sigma=sigma))
        single, out["sor"]["single_wall_s"] = timed(lambda: sor.sor_mask(sor_pos, k, sigma))
        out["sor"]["equal"] = bool(torch.equal(mask, single))
        x, chunks, kc = md_chunked_input()
        n = x.shape[0]
        chunk = next_pow2(-(-n // chunks), floor=max(256, kc))
        xp = pad_rows(x, chunk * chunks, PAD_POS)
        reset_counts()
        (c, labels), wall = timed(lambda: pd.sharded_kmeans_chunked(
            xp, n, chunks, kc, 10, 100, mesh))
        out["chunked"] = dict(shape=[chunks, chunk, SOG_D, kc], wall_s=wall,
                              launches=kernel_counts(), bytes=dict(pd.BYTES))
        (c1, l1), out["chunked"]["single_wall_s"] = timed(
            lambda: km.kmeans_chunked(x, chunks, kc, max_iter=10, seed=100))
        out["chunked"]["bit_identical"] = bool(torch.equal(c, c1)
                                               and torch.equal(labels[:n], l1))
        expect = dict(centroids=tensor_digest(c1), labels=tensor_digest(l1))
        del x, xp, c, labels, c1, l1
        rr = np.random.default_rng(6)
        x = torch.from_numpy(rr.normal(0, 1, (K34_N, K34_D)).astype(np.float32)).to(DEVICE)
        reset_counts()
        (c, labels), wall = timed(lambda: pd.sharded_kmeans(x, K34_K, mesh, max_iter=10))
        out["kmeans"] = dict(shape=[K34_N, K34_D, K34_K], wall_s=wall,
                             launches=kernel_counts(), bytes=dict(pd.BYTES),
                             finite=bool(torch.isfinite(c).all()),
                             labels_equal_plain=float((labels == km._assign_ref(x, c))
                                                      .float().mean()))
        del x, c, labels
        rend = md_render_rank(mesh, render_kw)
    finally:
        dist.destroy_process_group()
    log(f"[multidevice] one-rank {out['backend']} group on {smi}: {json.dumps(out)}")
    if not out["sor"]["equal"]:
        fail("the sharded SOR mask differs from sor_mask's")
    if not out["chunked"]["bit_identical"]:
        fail("sharded_kmeans_chunked differs from kmeans_chunked")
    if not out["kmeans"]["finite"] or out["kmeans"]["labels_equal_plain"] < 1.0:
        fail("sharded_kmeans' labels differ from the plain assign of its centroids")
    for path, kernels in (("sor", ("k1",)), ("chunked", ("k2", "k4")), ("kmeans", ("k3",))):
        for key in kernels:
            if out[path]["launches"][key] < 1:
                fail(f"phase 10's {path} never launched {key.upper()}")
    log(f"[multidevice-render] one-rank {out['backend']} group on {smi}: {json.dumps(rend)}")
    check_md_render("the one-rank group", rend)
    if not rend["sharded_render"]["equal_single"]:
        fail("at one rank sharded_render differs from render(bg=0)")
    if rend["band_occupancy"]["occupancy"] != [[rend["in_front"]]]:
        fail(f"at one rank band_occupancy is {rend['band_occupancy']['occupancy']}, not "
             f"the {rend['in_front']} splats in front of the camera")
    return out, expect, rend


def md_worker(rank, world, root, cfg):
    """One rank of phase 10 (b): a gloo group, every rank on one card."""
    import pickle

    import torch.distributed as dist
    from gsconverter_tpu_torch.converter import Converter
    from gsconverter_tpu_torch.ops import kmeans as km
    from gsconverter_tpu_torch.parallel import distributed as pd
    from gsconverter_tpu_torch.parallel.mesh import make_mesh, set_active_mesh

    globals().update(cfg["settings"])  # the parent's sizes and device
    # count the sharded calls, so that a path the dispatch declined (every
    # rank then runs every chunk alone) cannot pass for a sharded one
    calls = dict(sor=0, chunked=0)

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped
    pd.sharded_sor_mask = counting("sor", pd.sharded_sor_mask)
    pd.sharded_kmeans_chunked = counting("chunked", pd.sharded_kmeans_chunked)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(device=DEVICE)
        set_active_mesh(mesh)
        out = {}
        for label, src, fmt, flags in (
                ("splat", cfg["main_src"], "splat", MAIN_FLAGS),
                ("sog", cfg["sog_src"], "sog", dict(compression_level=MD_SOG_LEVEL))):
            path = os.path.join(root, f"md.{fmt}")
            conv = Converter(src, path, fmt, device=DEVICE)
            reset_counts()
            calls.update(dict.fromkeys(calls, 0))
            _, wall = timed(lambda: conv.run(**flags))
            out[label] = dict(wall_s=wall, launches=kernel_counts(), bytes=dict(pd.BYTES),
                              sharded_calls=dict(calls), stages_s=conv.timer.report())
            if rank == 0:
                out[label]["sha256"] = file_digest(path)
            # the same conversion again: this process's first calls are behind it
            conv = Converter(src, path, fmt, device=DEVICE)
            _, out[label]["second_wall_s"] = timed(lambda: conv.run(**flags))
            out[label]["second_stages_s"] = conv.timer.report()
            if rank == 0:
                out[label]["repeat_identical"] = file_digest(path) == out[label]["sha256"]
            mesh.barrier()
        x, chunks, kc = md_chunked_input()
        reset_counts()
        calls.update(dict.fromkeys(calls, 0))
        (c, labels), wall = timed(lambda: km.kmeans_chunked(x, chunks, kc, max_iter=10,
                                                            seed=100))
        out["chunked"] = dict(wall_s=wall, launches=kernel_counts(), bytes=dict(pd.BYTES),
                              sharded_calls=dict(calls), centroids=tensor_digest(c),
                              labels=tensor_digest(labels))
        del x, c, labels
        out["render"] = md_render_rank(mesh, cfg["render_kw"])
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_multidevice_gloo(smi, main_src, runs, expect, render_kw):
    """Phase 10 (b): MD_WORLD ranks over gloo on the one card (collectives
    staged through the host): config 2's 1M scene to .splat, a 200k-splat
    ply -> sog and config 3's chunked palette fit, each against its
    single-process result; then phase 11 (b) on the same ranks."""
    import pickle

    import torch.multiprocessing as mp
    from gsconverter_tpu_torch.converter import Converter

    root = os.path.join(OUT_DIR, "md_gloo")
    os.makedirs(root, exist_ok=True)
    sog_src = os.path.join(root, "scene_md_sog.ply")
    mint_scene(sog_src, MD_SOG_N, seed=12, flyers=0.0)
    single = os.path.join(root, "single.sog")
    Converter(sog_src, single, "sog", device=DEVICE).run(compression_level=MD_SOG_LEVEL)
    sog_digest = file_digest(single)
    cfg = dict(main_src=main_src, sog_src=sog_src, render_kw=render_kw, settings={
        name: globals()[name] for name in ("DEVICE", "MAIN_FLAGS", "SOG_N", "SOG_D",
                                           "SOG_CHUNKS", "K2_KS", "MD_SOG_LEVEL", "RENDER_N",
                                           "RENDER_H", "RENDER_W", "TRAIN_LR")})
    t0 = time.perf_counter()
    mp.spawn(md_worker, args=(MD_WORLD, root, cfg), nprocs=MD_WORLD, join=True)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(MD_WORLD):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(root)
    out = dict(world=MD_WORLD, backend="gloo", device=DEVICE, spawn_wall_s=wall,
               splat_identical_to_phase4=ranks[0]["splat"]["sha256"] == runs["splat"]["sha256"],
               sog_identical_to_single=ranks[0]["sog"]["sha256"] == sog_digest,
               chunked_bit_identical=all(
                   rk["chunked"]["centroids"] == expect["centroids"]
                   and rk["chunked"]["labels"] == expect["labels"] for rk in ranks),
               ranks=[{key: {f: v for f, v in rk[key].items()
                             if f not in ("sha256", "centroids", "labels")}
                       for key in rk if key != "render"} for rk in ranks])
    log(f"[multidevice] {MD_WORLD} gloo ranks on {smi}: {json.dumps(out)}")
    if not out["splat_identical_to_phase4"]:
        fail("the gloo world's .splat differs from phase 4's")
    if not out["sog_identical_to_single"]:
        fail("the gloo world's .sog differs from the single-process file")
    if not out["chunked_bit_identical"]:
        fail("the gloo world's chunked K-Means differs from kmeans_chunked")
    if not (ranks[0]["splat"]["repeat_identical"] and ranks[0]["sog"]["repeat_identical"]):
        fail("the gloo world's second .splat or .sog differs from its first")
    for r, rk in enumerate(ranks):
        for path, kernels in (("splat", ("k1",)), ("sog", ("k2", "k4")),
                              ("chunked", ("k2", "k4"))):
            for key in kernels:
                if rk[path]["launches"][key] < 1:
                    fail(f"rank {r} of phase 10's gloo world never launched "
                         f"{key.upper()} on its {path} path")
        # each path went through its sharded function, which exchanged data
        for path, call, wire in (("splat", "sor", "halo"), ("sog", "chunked", "all_gather"),
                                 ("chunked", "chunked", "all_gather")):
            if rk[path]["sharded_calls"][call] != 1 or rk[path]["bytes"][wire] <= 0:
                fail(f"rank {r} of phase 10's gloo world did not take the sharded "
                     f"{call} path on its {path} run: calls {rk[path]['sharded_calls']}, "
                     f"bytes {rk[path]['bytes']}")
    rend = [rk["render"] for rk in ranks]
    log(f"[multidevice-render] {MD_WORLD} gloo ranks on {smi}: {json.dumps(rend)}")
    check_md_render_world(rend)
    out["render"] = rend
    return out


def check_md_render_world(rend):
    """Phase 11 (b)'s bars over the gloo ranks' ``md_render_rank`` results."""
    for r, rr in enumerate(rend):
        check_md_render(f"rank {r} of the gloo world", rr)
        if rr["band_occupancy"]["occupancy"] != rr["band_occupancy"]["plain"]:
            fail(f"rank {r}'s band_occupancy {rr['band_occupancy']['occupancy']} differs "
                 f"from its plain count {rr['band_occupancy']['plain']}")
        for key, wire in (("sharded_render", "scan"), ("sharded_render", "all_reduce"),
                          ("sharded_render_tiles", "all_to_all"),
                          ("sharded_render_tiles", "all_gather"), ("step", "all_reduce")):
            if rr[key]["bytes"][wire] <= 0:
                fail(f"rank {r}'s {key} sent no {wire} bytes: {rr[key]['bytes']}")
    for key in ("band_occupancy", "step"):
        field = "occupancy" if key == "band_occupancy" else "params_sha256"
        if any(rr[key][field] != rend[0][key][field] for rr in rend):
            fail(f"the gloo ranks' {key} results differ: {[rr[key][field] for rr in rend]}")


# ------------------------------ phase 11: the multi-device renderer and step


def md_render_scene():
    """Phase 8's 1M-splat scene (seed 0) on the card and its camera."""
    from gsconverter_tpu_torch.render import rasterizer as rz

    cloud = render_bench_scene(RENDER_N).to_device(DEVICE)
    cam = rz.Camera.look_at(eye=[0, 0, 5.0], target=[0, 0, 0], fov_deg=60.0,
                            width=RENDER_W, height=RENDER_H)
    return cloud, cam


def md_render_kw():
    """Phase 11's render settings: phase 8's windowed render with its
    auto_budget's max_per_tile and max_global, and no band plan (a band
    plan belongs to one image)."""
    from gsconverter_tpu_torch.render import rasterizer as rz

    cloud, cam = md_render_scene()
    budget = rz.auto_budget(cloud, cam)
    return dict(binning="windowed", block_m=RENDER_BM, max_per_tile=budget["max_per_tile"],
                max_global=budget["max_global"])


def plain_occupancy(proj, h, size):
    """band_occupancy's matrix counted in numpy: each splat's clipped rows
    y +- radius floor-divided into bands, by the chunk of rows it lies in."""
    rows_per = h // size
    y = proj["means2d"][:, 1].detach().cpu().numpy()
    r = proj["radius"].detach().cpu().numpy()
    front = proj["in_front"].cpu().numpy()
    d0 = np.floor_divide(np.clip(y - r, 0, h - 1), rows_per).astype(np.int32)
    d1 = np.floor_divide(np.clip(y + r, 0, h - 1), rows_per).astype(np.int32)
    src = np.arange(y.shape[0]) // (y.shape[0] // size)
    occ = np.zeros((size, size), np.int64)
    for j in range(size):
        np.add.at(occ[:, j], src[front & (d0 <= j) & (d1 >= j)], 1)
    return occ.tolist()


def md_render_rank(mesh, kw):
    """Phase 11 on one rank of ``mesh``: sharded_render, band_occupancy
    and sharded_render_tiles of phase 8's scene, and one sharded training
    step beside make_train_step's from the same parameters.  Each call's
    K5 / K6 launches and bytes are counted over its first call, whose host
    time is taken; the second call is timed by CUDA events.  Images are
    held against this rank's single-device render (PSNR, max |diff|)."""
    from gsconverter_tpu_torch.parallel import distributed as pd
    from gsconverter_tpu_torch.parallel.sharding import pad_cloud
    from gsconverter_tpu_torch.parallel.train import make_sharded_train_step
    from gsconverter_tpu_torch.render import rasterizer as rz
    from gsconverter_tpu_torch.render import train
    from gsconverter_tpu_torch.render.project import project_gaussians

    cloud, cam = md_render_scene()
    cloud, _ = pad_cloud(cloud, mesh.size)
    with torch.no_grad():
        single = rz.render(cloud, cam, **kw)
    out = dict(world=mesh.size, rank=mesh.rank, kw=kw)

    def counted(fn):
        rz.LAUNCHES.update(dict.fromkeys(rz.LAUNCHES, 0))
        pd.BYTES.update(dict.fromkeys(pd.BYTES, 0))
        res, first_s = timed(fn)
        entry = dict(launches=dict(rz.LAUNCHES), bytes=dict(pd.BYTES), first_s=first_s)
        return res, entry

    def second_ms(fn):
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def against_single(img):
        return dict(psnr_db=float(rz.psnr(img, single)),
                    max_abs=float((img - single).abs().max()),
                    shape=list(img.shape), finite=bool(torch.isfinite(img).all()))

    with torch.no_grad():
        fn = lambda: pd.sharded_render(cloud, cam, mesh, **kw)  # noqa: E731
        img, e = counted(fn)
        e.update(against_single(img), equal_single=bool(torch.equal(img, single)),
                 second_ms=second_ms(fn))
        out["sharded_render"] = e
        fn = lambda: pd.band_occupancy(cloud, cam, mesh)  # noqa: E731
        occ, e = counted(fn)
        proj = project_gaussians(cloud.pos, cloud.log_scale, cloud.quat,
                                 cam.to(cloud.pos.device))
        e.update(occupancy=occ.tolist(), plain=plain_occupancy(proj, cam.height, mesh.size),
                 second_ms=second_ms(fn))
        out["in_front"] = int(proj["in_front"].sum())
        out["band_occupancy"] = e
        del proj
        fn = lambda: pd.sharded_render_tiles(cloud, cam, mesh, **kw)  # noqa: E731
        img, e = counted(fn)
        e.update(against_single(img), second_ms=second_ms(fn))
        out["sharded_render_tiles"] = e
        del img

    # one step towards the image, from the perturbed scene, on one device
    # and over the mesh
    base = cloud.replace(sh_dc=cloud.sh_dc + 0.2, opacity=cloud.opacity - 0.3)

    def fresh():
        params = {k: getattr(base, k).detach().clone().requires_grad_(True)
                  for k in train.TRAINABLE}
        opt = torch.optim.Adam(list(params.values()), lr=TRAIN_LR, betas=(0.9, 0.999),
                               eps=1e-8)
        return params, opt

    p1, o1 = fresh()
    loss1 = float(train.make_train_step(base, cam, o1, p1, **kw)(single))
    g1 = {k: v.grad for k, v in p1.items()}
    del p1, o1
    p2, o2 = fresh()
    step = make_sharded_train_step(base, cam, o2, p2, mesh, **kw)
    loss2, e = counted(lambda: float(step(single)))
    grad_rel = {}
    for k, v in p2.items():
        if (v.grad is None) != (g1[k] is None):
            fail(f"the sharded step's {k} gradient is {v.grad is None and 'missing' or 'there'}"
                 f", make_train_step's is not")
        if v.grad is not None:
            grad_rel[k] = float((v.grad - g1[k]).abs().max()
                                / g1[k].abs().max().clamp_min(1e-30))
    digest = hashlib.sha256(b"".join(v.detach().cpu().numpy().tobytes()
                                     for v in p2.values())).hexdigest()
    e.update(loss=loss2, single_loss=loss1, loss_rel=abs(loss2 - loss1) / max(abs(loss1), 1e-30),
             grad_rel_of_max=grad_rel, params_sha256=digest,
             second_ms=second_ms(lambda: step(single)))
    out["step"] = e
    del p2, o2, g1, base, single
    torch.cuda.empty_cache()
    return out


def check_md_render(who, r):
    """Phase 11's bars for one rank's ``md_render_rank`` results."""
    for key in ("sharded_render", "sharded_render_tiles"):
        e = r[key]
        if not e["finite"] or e["shape"] != [RENDER_H, RENDER_W, 3]:
            fail(f"{who}: {key} gave a non-finite image or one of shape {e['shape']}")
        if e["psnr_db"] < MD_RENDER_DB:
            fail(f"{who}: {key} reaches {e['psnr_db']:.2f} dB against one device's render, "
                 f"not {MD_RENDER_DB}")
    st = r["step"]
    if st["loss_rel"] > MD_LOSS_REL or max(st["grad_rel_of_max"].values()) > MD_GRAD_REL:
        fail(f"{who}: the sharded step's loss ({st['loss_rel']:.3g} rel) or gradients "
             f"({st['grad_rel_of_max']}) differ from make_train_step's")
    for key, want in (("sharded_render", {"composite_fwd": 2, "composite_bwd": 0}),
                      ("band_occupancy", {"composite_fwd": 0, "composite_bwd": 0}),
                      ("sharded_render_tiles", {"composite_fwd": 1, "composite_bwd": 0}),
                      ("step", {"composite_fwd": 1, "composite_bwd": 1})):
        if r[key]["launches"] != want:
            fail(f"{who}: {key} launched {r[key]['launches']}, not {want}")


def md_render_launches(key, one, gloo):
    """K5's or K6's launches on each call of phase 11, by rank."""
    calls = ("sharded_render", "sharded_render_tiles", "step")
    out = {f"one_rank.{c}": one[c]["launches"][key] for c in calls}
    for r, rr in enumerate(gloo):
        out.update({f"gloo_rank{r}.{c}": rr[c]["launches"][key] for c in calls})
    return out


def md_launches(key, one, gloo):
    """A kernel's launches on each path of phase 10, by rank."""
    out = {f"one_rank.{path}": one[path]["launches"][key]
           for path in ("sor", "chunked", "kmeans")}
    for r, rk in enumerate(gloo["ranks"]):
        out.update({f"gloo_rank{r}.{path}": rk[path]["launches"][key]
                    for path in ("splat", "sog", "chunked")})
    return out


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
    sources = ("sor_window", "kmeans", "kmeans_update", "composite")
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
    # 9. the device-resident path (config 2 as a device cloud, checkpoints)
    dev_chain = phase_device_chain(sor, smi, main_src, runs)
    ckpt = phase_checkpoint(sor, smi, main_src, runs)
    # 10. the multi-device layer: a one-rank NCCL group, then gloo ranks on
    # the one card
    # 11. the multi-device renderer and training step, in phase 10's group
    # and gloo world
    real = spos[:, 0] < sor._D_VALID_MAX
    render_kw = md_render_kw()
    md_one, md_expect, md_render_one = phase_multidevice_one_rank(
        sor, km, smi, spos[real].contiguous(), render_kw)
    md_gloo = phase_multidevice_gloo(smi, main_src, runs, md_expect, render_kw)
    os.unlink(main_src)
    small_same = phase_small_agreement(sor)
    # 5. K1 on the main path's own input
    r = compare_k1(sor, spos, k, window, iters, real=real)
    r.update(n=spos.shape[0], k=k, window=window, iters=iters)
    log(f"[k1] main-path input: {json.dumps(r)}")
    # 9. density on the wide grid; the SOR grid at the main path's n
    wide, sor_grid = phase_density_sor(sor, smi, spos[real].contiguous())
    # 6. K2, K3, K4 against their plain versions
    k2 = phase_k2(km)
    k3, k4 = phase_k3_k4(km)
    # 7. the SOG path
    sog_runs = phase_sog(km, smi)
    small_sog = phase_small_sog()
    # 9. config 3 as a device cloud
    dev_sog = phase_device_sog(km, smi, sog_runs)
    # 8. config 4: the renderer
    rend = phase_render(smi)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    log(f"[done] phases 3-11 in {time.perf_counter() - t_all:.1f} s; "
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
                                 batch=batch["launches"], device_cloud=dev_chain["launches"],
                                 checkpointed=ckpt["first"]["launches"],
                                 resumed=ckpt["resumed"]["launches"]),
        "launches_multidevice": md_launches("k1", md_one, md_gloo),
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
        "device_cloud_launches_by_level": {lv: run["launches"]["lloyd"]
                                           for lv, run in dev_sog.items()},
        "launches_multidevice": md_launches("k2", md_one, md_gloo),
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
        # no conversion path calls K3: the SOG path's count (0); phase 10's
        # direct sharded_kmeans call launches it (launches_multidevice)
        "launches": sog_runs[SOG_LEVELS[0]]["launches"]["assign"],
        "launches_multidevice": md_launches("k3", md_one, md_gloo),
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
        "device_cloud_launches_by_level": {lv: run["launches"]["update"]
                                           for lv, run in dev_sog.items()},
        "launches_multidevice": md_launches("k4", md_one, md_gloo),
        "ordered_equal": k4["ordered_equal"],
        "shape": {"n": K34_N, "d": K34_D, "k": K34_K},
        # on the main path K4 sums K2's segments: n = chunks * rows, k =
        # chunks * k, held bit for bit there by K2's sums_ordered_equal
        "main_path_shape": {"n": main_k2["chunks"] * main_k2["rows"], "d": main_k2["d"],
                            "k": main_k2["chunks"] * main_k2["k"]},
    }]
    bands, check = rend["bands"], rend["band_check"]
    band_shapes = [{k: b[k] for k in ("tiles", "m", "walked_pairs", "nonzero_pairs")}
                   for b in bands]
    composite_src = "gsconverter_tpu_torch/csrc/composite.cu"
    for key, name, replaces, err in (
            ("k5", "K5 composite_fwd", "gsconverter_tpu/render/rasterizer.py:138",
             check["rgb_max_abs_err"]),
            ("k6", "K6 composite_bwd", "gsconverter_tpu/render/rasterizer.py:204",
             check["grad_max_abs_err"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": composite_src,
            "replaces": replaces,
            "launches": rend["launches"][f"composite_{'fwd' if key == 'k5' else 'bwd'}"],
            "max_abs_err": err,
            # a frame: the sum over its bands, one launch each
            "ms": sum(b[f"{key}_ms"] for b in bands),
            "plain_ms": sum(b[f"{key}_plain_ms"] for b in bands),
            "bound_ms": sum(b[f"{key}_bound_ms"] for b in bands),
            "bound_by": ("operations" if all(b[f"{key}_bound_by"] == "operations"
                                             for b in bands) else "bytes"),
            "library_ms": None,  # no single PyTorch call composites tiles
            "per_band_ms": [b[f"{key}_ms"] for b in bands],
            "shape": {"bands": band_shapes, "block_m": RENDER_BM},
            "launches_multidevice": md_render_launches(
                f"composite_{'fwd' if key == 'k5' else 'bwd'}", md_render_one,
                md_gloo["render"]),
        })
    kernels[-2]["band_check"] = check
    for key, entry in zip(("k5", "k6"), kernels[-2:]):
        entry["ptxas"] = rend[key]["ptxas"]
        # the kernels' own device time, without the host's launch overhead
        entry["device_ms"] = rend[key]["device_frame_ms"]
    kernels[-1]["warp_candidate_live_share"] = rend["k6"]["warp_candidate_live_share"]
    log(f"[render] config 4 on {smi}: " + json.dumps(
        {k: v for k, v in rend.items() if k not in ("bands", "band_check")}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

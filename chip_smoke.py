"""Smoke run of gsconverter_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit; TF32 off;
  2. build: kernel K1 (csrc/sor_window.cu) with nvcc, timed;
  3. K1 against its plain PyTorch version at two settings on the card
     (4,194,304 points at k=25, sigma=10.5: one pass, window 256, 7 steps;
     1,048,576 points at k=25, sigma=2.0: two passes, window 512, 10 steps):
     md and the full SOR mask, with times;
  4. the main path at full size: a 1M-splat 3DGS PLY through convert() to
     .splat and to 3DGS PLY with the filters bbox, min_opacity=5,
     density_sensitivity=0.5 and sor_intensity=4 on device="cuda", with its
     launch counts, output checks and per-stage times; then a 20k-splat
     scene with isolated flyers inside the bbox through bbox, min_opacity=5
     and sor_intensity=4 on "cuda" and on "cpu": SOR must drop rows on both
     and the outputs must agree;
  5. K1 against its plain version on the input the main path gave it.

The line before the last two is a JSON object listing every ported kernel;
then the card's name and power limit from nvidia-smi; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result
and exits 1.  Everything it writes goes under build/chip_smoke/.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, 700 W): 67 TFLOP/s FP32
# outside the tensor cores counts a fused multiply-add as two operations,
# so single FP32 instructions (add, mul, compare, max, conversion) issue at
# half that; HBM3 bandwidth.
FP32_INSTR_RATE = 33.5e12
PEAK_BYTES = 3.35e12
# FP32 instructions K1's function needs per (point, candidate) pair, each
# distance computed once: the distance (3 sub, 3 mul, 2 add, sqrt counted
# as one, 2 validity compares, the bf16 round trip: 12), the all-candidate
# stats (count, sum, max: 3), the final pass (compare, count, sum: 3), and
# 2 per bisection step (compare, count).  The middle-block count and max
# add 2 for 512 of the 512 + 2w candidates.
K1_DIST_OPS, K1_STATS_OPS, K1_FINAL_OPS, K1_STEP_OPS, K1_MID_OPS = 12, 3, 3, 2, 2
BBOX = (-60.0, -60.0, -60.0, 60.0, 60.0, 60.0)
MAIN_FLAGS = dict(bbox=BBOX, min_opacity=5, density_sensitivity=0.5,
                  sor_intensity=4)
# the 20k scene's flags: without the density filter, which would take the
# inner flyers before SOR sees them
SOR_FLAGS = dict(bbox=BBOX, min_opacity=5, sor_intensity=4)
INNER_FLYERS = 10
# (points, k, sigma) of phase 3, and the main path's scene size
K1_SETTINGS = ((4_194_304, 25, 10.5), (1_048_576, 25, 2.0))
MAIN_N = 1_000_000
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
    return results


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
            os.unlink(out)
    finally:
        sor._sor_window_loop_kernel = wrapper
    if runs["splat"]["kept"] != runs["3dgs"]["kept"]:
        fail("ply -> splat and ply -> 3dgs kept different splats")
    if runs["splat"]["launches"] != runs["3dgs"]["launches"]:
        fail("ply -> splat and ply -> 3dgs launched K1 a different number of times")
    os.unlink(src)
    return runs, seen[0]


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
    return same


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

    from gsconverter_tpu_torch.ops import sor
    from gsconverter_tpu_torch.utils import cuda_build

    # 2. build
    t0 = time.perf_counter()
    cuda_build.build("sor_window")
    log(f"[build] sor_window built in {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.BUILD_LOG.get("sor_window", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    os.makedirs(OUT_DIR, exist_ok=True)
    t_all = time.perf_counter()
    # 3. K1 at the SOR bench's settings
    settings = phase_k1_settings(sor)
    # 4. the main path
    runs, (spos, k, window, iters) = phase_main_path(sor, smi)
    small_same = phase_small_agreement(sor)
    # 5. K1 on the main path's own input
    real = spos[:, 0] < sor._D_VALID_MAX
    r = compare_k1(sor, spos, k, window, iters, real=real)
    r.update(n=spos.shape[0], k=k, window=window, iters=iters)
    log(f"[k1] main-path input: {json.dumps(r)}")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    log(f"[done] phases 3-5 in {time.perf_counter() - t_all:.1f} s; "
        f"small scene byte-identical={small_same}")

    kernels = [{
        "name": "K1 sor_window_md",
        "route": "cuda",
        "source": "gsconverter_tpu_torch/csrc/sor_window.cu",
        "replaces": "gsconverter_tpu/ops/sor.py:315",
        "launches": runs["splat"]["launches"],
        "max_abs_err": r["max_abs_err"],
        "max_rel": r["max_rel"],
        "ms": r["kernel_ms"],  # the key the harness reads
        "kernel_ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
        "main_path_shape": {"n": r["n"], "k": k, "window": window, "iters": iters},
        "settings": settings,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

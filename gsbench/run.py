"""Run one cell of the port's benchmark once and print its result.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, ``gsbench/`` and
the port (``gsconverter_tpu_torch``).  The run makes its inputs from the
seed and warms up (``setup_s``), drives the cell's closed loop for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or a short
stretch under torch.profiler (``--trace 1``: its per-layer metrics), checks
what that loop produced against the plain reference in
``gsbench/reference/``, and prints one JSON object as the last line of
standard output; the numbers compared, each beside its limit, are also the
last lines of standard error.  Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits 2; it exits 3 if
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gsbench import spec, trace as trace_mod  # noqa: E402

#: top-level module names no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "gsconverter_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def execute(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
            scratch: Path, t_start: float = T_START, on_checked=None) -> dict:
    """Set up, measure and check one run of ``cell``; the result's fields.
    Takes no notice of whether a card is present: ``main`` does.
    ``on_checked(loop)`` runs after the check (calibration reads the
    control there).  A loop's ``reference_s``, the seconds its set-up spent
    in the reference, is left out of ``setup_s``."""
    import torch

    loop = spec.traffic_loop(cell.traffic["kind"]).Loop(cell, seed, device, scratch)
    try:
        t_setup = time.perf_counter()
        loop.setup()
        # set-up less what the reference spent making inputs (a target frame)
        setup_s = time.perf_counter() - t_start - getattr(loop, "reference_s", 0.0)
        print(f"gsbench: set-up {setup_s:.3f} s, {t_setup - t_start:.3f} s of it before the "
              f"cell's own, then {loop.phases.log}", file=sys.stderr)
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        tr = None
        if traced:
            before = loop.counters()
            tr = trace_mod.record(loop.traced_iteration, int(cell.traffic["trace_iterations"]),
                                  scratch, on_card=device == "cuda")
            after = loop.counters()
            tr.launches = {k: after[k] - before[k] for k in after}
            tr.stages = loop.stages
            attempted = tr.iterations
        else:
            times = []
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                ti = time.perf_counter()
                loop.iteration()
                times.append(time.perf_counter() - ti)
            sync()
            window_s = time.perf_counter() - t0
            attempted = len(times)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        loop.release()
        t_check = time.perf_counter()
        checks = loop.check()
        print(f"gsbench: the check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
        if on_checked is not None:
            on_checked(loop)
        metrics = {}
        if traced:
            tr.work = loop.work()
            for m in cell.per_layer:
                value = spec.metric_reader(m["name"]).read(tr)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        else:
            values = dict(loop.e2e(window_s, times), setup_s=setup_s)
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    finally:
        loop.close()
    failed = sum(1 for c in checks if not c["value"] <= c["limit"])
    out = {"correct": failed == 0, "attempted": attempted, "failed": failed,
           "metrics": metrics, "memory_peak_bytes": peak}
    if tr is not None:
        out["busy_s"], out["window_s"] = tr.busy_s(), tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return res.stdout.strip().replace("\n", "; ") or "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's progress bars stay off (its kernels build inside the
    # checkout, under build/gsconverter_tpu_torch)
    os.environ["TQDM_DISABLE"] = "1"
    cell = spec.cell(spec.load_benchmark(), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gsbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="gsbench-") as tmp:
        # the program's own messages go to standard error: the result is the
        # last line of standard output
        with contextlib.redirect_stdout(sys.stderr):
            out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", Path(tmp))
    found = forbidden_modules()
    if found:
        print(f"gsbench: the run loaded {found}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(out.pop("memory_peak_bytes")),
              "power": power_limit()}
    if args.trace:
        device["busy_s"], device["window_s"] = out.pop("busy_s"), out.pop("window_s")
    checks = out.pop("checks")
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

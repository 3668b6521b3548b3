"""The traced stretch of a ``--trace 1`` run and what the metric readers see.

``torch.profiler`` records CPU and CUDA activity over a short steady
stretch of the cell's loop; its Chrome trace gives every kernel, copy and
fill on the device and every operator and annotation on the host.
``Trace`` holds them with the loop's own records (stage times, the port's
launch counters, the reference's operation counts), and the readers in
``gsbench/metrics/`` take their numbers from it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np

# Published H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): FP32 outside
# the tensor cores at 67 TFLOP/s counts a fused multiply-add as two
# operations, so single FP32 instructions run at half that; HBM3 at
# 3.35 TB/s; bf16 on the tensor cores at 989 TFLOP/s (a multiply-add two
# operations).
FP32_INSTR_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOP_PER_S = 989e12

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAP_SAMPLE_US = 200.0
HOST_CATS = ("user_annotation", "cpu_op")


@dataclasses.dataclass
class Trace:
    iterations: int  # steps, frames or conversions in the stretch
    window_s: float  # host wall of the stretch, ending in a synchronize
    device: list  # (name, start_us, dur_us) of every device activity
    host: list  # (name, start_us, dur_us, cat) of host operators and annotations
    stages: dict = dataclasses.field(default_factory=dict)  # name -> [seconds]
    launches: dict = dataclasses.field(default_factory=dict)  # port counter -> count
    work: dict = dataclasses.field(default_factory=dict)  # reference counts

    def kernel(self, function: str) -> tuple[float, int]:
        """(seconds, launches) of the device kernels of ``function``."""
        hits = [d for n, _, d in self.device if function in n]
        return sum(hits) * 1e-6, len(hits)

    def device_s(self) -> float:
        return sum(d for _, _, d in self.device) * 1e-6

    def _merged(self) -> list:
        spans = sorted((s, s + d) for _, s, d in self.device)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._merged()) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        between device activity by the innermost host operator or
        annotation covering it (sampled at each gap's middle and every
        ``GAP_SAMPLE_US`` along a longer one)."""
        ops: dict = {}
        for name, _, d in self.device:
            ops[name] = ops.get(name, 0.0) + d * 1e-6
        gaps: dict = {}
        merged = np.asarray(self._merged(), dtype=np.float64).reshape(-1, 2)
        g0, glen = merged[:-1, 1], merged[1:, 0] - merged[:-1, 1]
        k = np.maximum(1, (glen // GAP_SAMPLE_US).astype(np.int64))
        gap_of = np.repeat(np.arange(len(glen)), k)
        first = np.repeat(np.cumsum(k) - k, k)
        at = g0[gap_of] + (np.arange(len(gap_of)) - first + 0.5) / k[gap_of] * glen[gap_of]
        weight = (glen / k)[gap_of] * 1e-6
        h_start = np.asarray([h[1] for h in self.host], dtype=np.float64)
        h_end = h_start + np.asarray([h[2] for h in self.host], dtype=np.float64)
        # a sample no operator covers takes the last column
        h_len = np.append(h_end - h_start, 1e300)
        names = [h[0] for h in self.host] + ["host: outside any operator"]
        for c in range(0, len(at), 256):
            m = at[c:c + 256, None]
            cover = (h_start[None, :] <= m) & (h_end[None, :] >= m)
            cover = np.concatenate([cover, np.ones((len(m), 1), bool)], axis=1)
            inner = np.where(cover, h_len[None, :], np.inf).argmin(axis=1)
            for j, w in zip(inner, weight[c:c + 256]):
                gaps[names[j]] = gaps.get(names[j], 0.0) + w
        by = lambda d: sorted(([k[:120], v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": by(ops), "idle_gaps": by(gaps)}


def roofline_s(ops: float, nbytes: float, tc_flops: float = 0.0) -> float:
    """Least time on the card for ``ops`` FP32 instructions, ``nbytes`` of
    HBM traffic and ``tc_flops`` bf16 tensor-core operations."""
    return max(ops / FP32_INSTR_PER_S, nbytes / HBM_BYTES_PER_S, tc_flops / BF16_TC_FLOP_PER_S)


def roofline_share(tr: Trace, function: str, counter: str, work: str):
    """The least time the work ``tr.work[work]`` needs on the card over the
    device time of ``function``'s kernels, in %; None where the profiler's
    launches of it differ from the port's counter ``counter`` (a dropped
    event would read high) or nothing was counted.  A work entry holds
    ``ops`` and ``bytes``, and ``tc_flops`` where the kernel's products
    run on the tensor cores."""
    secs, count = tr.kernel(function)
    if count == 0 or count != tr.launches.get(counter) or work not in tr.work:
        return None
    w = tr.work[work]
    return 100.0 * roofline_s(w["ops"], w["bytes"], w.get("tc_flops", 0.0)) / secs


def stage_ms(tr: Trace, names) -> float | None:
    """Mean ms an iteration of the stages (or spans) ``names`` together."""
    if tr.iterations == 0 or not all(n in tr.stages for n in names):
        return None
    return sum(sum(tr.stages[n]) for n in names) / tr.iterations * 1e3


def idle_share(tr: Trace) -> float:
    """% of the stretch's wall in which nothing ran on the device."""
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def device_ms_besides(tr: Trace, functions: dict) -> float | None:
    """Device ms an iteration of every kernel, copy and fill but those of
    ``functions`` (function -> the port's launch counter); None where a
    count disagrees."""
    other = tr.device_s()
    for fn, counter in functions.items():
        secs, count = tr.kernel(fn)
        if count != tr.launches.get(counter):
            return None
        other -= secs
    return other / tr.iterations * 1e3


def record(loop, iterations: int, scratch: Path, on_card: bool = True) -> Trace:
    """Run ``loop(i)`` for ``iterations`` under torch.profiler and return
    the trace (the loop's own records are filled in by the caller).
    ``on_card=False`` (a CPU rehearsal) traces the host alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(iterations):
            loop(i)
        sync()
        window = time.perf_counter() - t0
    path = scratch / "gsbench_trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        item = (ev.get("name", ""), float(ev["ts"]), float(ev.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            device.append(item)
        elif cat in HOST_CATS:
            host.append(item + (cat,))
    return Trace(iterations=iterations, window_s=window, device=device, host=host)

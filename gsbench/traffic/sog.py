"""A closed loop of the port's ``Converter.run`` from one PLY to PlayCanvas
``.sog``.

Set-up mints the configuration's scene from the seed, writes it as a 3DGS
PLY with the benchmark's own writer and runs one conversion (which loads
the port's kernels).  Each conversion of the window reads the PLY, runs
the configuration's filter chain (none for BASELINE config 3) and writes
the ``.sog`` at the mix's compression level: the writer's stages, its
palette fit (kernel K2 and its sum stage K4 on the card), its WebP planes
and the zip.  A uniform sample of the files written, drawn from the seed,
is kept and held against the plain reference (``gsbench/reference/
sog.py``) texel by texel.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gsbench import common, scene
from gsbench.reference import sog as ref

# the writer's palette fit: this many Lloyd steps, then the final labels,
# one K2 launch and one K4 sum stage each
FIT_STEPS = 10
F32, I32 = 4, 4


def k2_k4_work(n: int, chunks: int, k: int, d: int, launches: int) -> dict:
    """K2's and K4's needed work over ``launches`` launches of a chunked fit
    of ``n`` real rows of ``d`` values, ``chunks`` chunks of ``k`` centroids.
    K2: the distance products of the real rows on the tensor cores (2 n k d
    operations; the padding rows are the kernel's own waste), reading the
    rows and the centroids and writing each row's label and segment.  K4:
    reading the real rows and their segments, writing each centroid's sums
    and count."""
    cents = chunks * k
    return {"k2": {"ops": 0.0, "tc_flops": 2.0 * n * k * d * launches,
                   "bytes": (n * d * F32 + cents * d * F32 + 2 * n * I32) * launches},
            "k4": {"ops": 0.0,
                   "bytes": (n * d * F32 + n * I32 + cents * (d + 1) * F32) * launches}}


def writer_stages(conv) -> list:
    """The SOG writer's own stage records of the conversion ``conv``; none
    from a port that does not keep them."""
    timer = getattr(getattr(conv, "target_handler", None), "timer", None)
    return list(getattr(timer, "records", []))


class Loop:
    def __init__(self, cell, seed: int, device: str, scratch):
        self.cfg, self.mix = cell.config, cell.traffic
        self.limits = cell.limits
        self.seed, self.device = seed, torch.device(device)
        self.level = int(self.mix["compression_level"])
        self.degree = int(self.cfg["scene"]["sh_degree"])
        self.stages: dict = {}
        self.window_stages: dict = {}
        self.traced = 0
        self.src = os.path.join(scratch, "scene.ply")
        self.out = os.path.join(scratch, "out.sog")
        self.kept = [os.path.join(scratch, f"kept{i}.sog")
                     for i in range(int(self.mix["sampled_outputs"]))]

    def setup(self):
        from gsconverter_tpu_torch.converter import Converter
        from gsconverter_tpu_torch.ops import kmeans

        self.Converter, self.kmeans = Converter, kmeans
        self.phases = ph = common.Phases()
        self.host = scene.to_host(scene.mint(self.cfg["scene"], self.seed, self.device))
        ph.mark("mint")
        scene.write_ply(self.src, self.host)
        ph.mark("write the PLY")
        self.sample = common.Reservoir(len(self.kept), self.seed)
        self._convert()
        ph.mark("a conversion")

    def _convert(self):
        conv = self.Converter(self.src, self.out, "sog", device=self.device)
        conv.run(compression_level=self.level, **self.cfg["filters"])
        return conv

    @staticmethod
    def _record(conv, into: dict):
        for name, dt, _ in conv.timer.records + writer_stages(conv):
            into.setdefault(name, []).append(dt)

    def iteration(self):
        conv = self._convert()
        self._record(conv, self.window_stages)
        slot = self.sample.slot()
        if slot is not None:
            os.replace(self.out, self.kept[slot])
            self.sample.items[slot] = self.kept[slot]

    def traced_iteration(self, i):
        conv = self._convert()
        self.traced += 1
        self._record(conv, self.stages)

    def counters(self) -> dict:
        return {"k2": self.kmeans.LAUNCHES["lloyd"], "k4": self.kmeans.LAUNCHES["update"]}

    def e2e(self, window_s, times) -> dict:
        spread = {k: [round(float(q), 4) for q in np.quantile(v, [0, 0.5, 1])]
                  for k, v in self.window_stages.items()}
        print(f"gsbench: stage seconds in the window (min, median, max): {spread}; "
              f"conversions (min, median, max): "
              f"{[round(float(q), 4) for q in np.quantile(times, [0, 0.5, 1])]}", file=sys.stderr)
        return {"convert_msplats_s": len(times) * self.cfg["scene"]["splats"] / window_s / 1e6}

    def release(self):
        pass

    def _expected(self, host):
        return ref.expected(host, self.level, self.degree, self.seed, self.device)

    def check(self) -> list:
        self.ref = self._expected(self.host)
        numbers = {}
        for path in [p for p in self.sample.items] or [self.out]:
            for k, v in ref.compare(ref.decode(path), self.ref, self.level).items():
                numbers[k] = max(numbers.get(k, v), v)
        return common.checks_from(numbers, self.limits)

    def control(self) -> dict:
        """The compared numbers with the reference on bfloat16 inputs in the
        program's place (after ``check``)."""
        return ref.compare(self._expected(common.bf16(self.host)), self.ref, self.level)

    def work(self) -> dict:
        n = int(self.cfg["scene"]["splats"])
        chunks, k, _ = ref.palette_layout(n, self.level)
        d = 3 * ((self.degree + 1) ** 2 - 1)
        return k2_k4_work(n, chunks, k, d, (FIT_STEPS + 1) * self.traced)

    def close(self):
        for p in [self.src, self.out] + self.kept:
            if os.path.exists(p):
                os.unlink(p)

"""A closed loop of the port's ``Converter.run`` from one PLY to one format.

Set-up mints the configuration's scene from the seed, writes it as a 3DGS
PLY with the benchmark's own writer and runs one conversion (which loads
the port's kernels).  Each conversion of the window reads the PLY, runs
the configuration's filter chain and writes the target file; a uniform
sample of the files written, drawn from the seed, is kept (moved aside)
and held against the reference's records of the same scene.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gsbench import common, scene
from gsbench.reference import convert as ref

class Loop:
    def __init__(self, cell, seed: int, device: str, scratch):
        self.cfg, self.mix = cell.config, cell.traffic
        self.limits, self.rules = cell.limits, cell.rules
        self.seed, self.device = seed, torch.device(device)
        self.scratch = scratch
        self.stages: dict = {}
        self.window_stages: dict = {}
        self.traced = 0
        fmt = self.mix["format"]
        self.src = os.path.join(scratch, "scene.ply")
        self.out = os.path.join(scratch, f"out.{fmt}")
        self.kept = [os.path.join(scratch, f"kept{i}.{fmt}")
                     for i in range(int(self.mix["sampled_outputs"]))]

    def setup(self):
        from gsconverter_tpu_torch.converter import Converter
        from gsconverter_tpu_torch.ops import sor

        self.Converter, self.sor = Converter, sor
        self.phases = ph = common.Phases()
        self.host = scene.to_host(scene.mint(self.cfg["scene"], self.seed, self.device))
        ph.mark("mint")
        scene.write_ply(self.src, self.host)
        ph.mark("write the PLY")
        self.sample = common.Reservoir(len(self.kept), self.seed)
        self._convert()
        ph.mark("a conversion")

    def _convert(self):
        conv = self.Converter(self.src, self.out, self.mix["format"], device=self.device)
        conv.run(**self.cfg["filters"])
        return conv

    def iteration(self):
        conv = self._convert()
        for name, dt, _ in conv.timer.records:
            self.window_stages.setdefault(name, []).append(dt)
        slot = self.sample.slot()
        if slot is not None:
            os.replace(self.out, self.kept[slot])
            self.sample.items[slot] = self.kept[slot]

    def traced_iteration(self, i):
        conv = self._convert()
        self.traced += 1
        for name, dt, _ in conv.timer.records:
            self.stages.setdefault(name, []).append(dt)

    def counters(self) -> dict:
        return {"k1": self.sor.KERNEL_LAUNCHES}

    def e2e(self, window_s, times) -> dict:
        spread = {k: [round(float(q), 4) for q in np.quantile(v, [0, 0.5, 1])]
                  for k, v in self.window_stages.items()}
        print(f"gsbench: stage seconds in the window (min, median, max): {spread}; "
              f"conversions (min, median, max): "
              f"{[round(float(q), 4) for q in np.quantile(times, [0, 0.5, 1])]}", file=sys.stderr)
        return {"convert_msplats_s": len(times) * self.cfg["scene"]["splats"] / window_s / 1e6}

    def release(self):
        pass

    def check(self) -> list:
        self.info = ref.keep_rows(self.host, self.cfg["filters"], self.device)
        band = self.rules["sor_band"]
        bad = max(ref.compare_splat(np.fromfile(p, dtype=ref.SPLAT), self.host, self.info, band)
                  for p in [p for p in self.sample.items] or [self.out])
        return common.checks_from({"bad_rows": bad}, self.limits)

    def control(self) -> dict:
        """The compared number with the reference on bfloat16 inputs in the
        program's place (after ``check``)."""
        low = common.bf16(self.host)
        got = ref.splat_file(low, ref.keep_rows(low, self.cfg["filters"], self.device)["kept"])
        return {"bad_rows": ref.compare_splat(got, self.host, self.info, self.rules["sor_band"])}

    def work(self) -> dict:
        return common.sor_work(self.info, self.traced)

    def close(self):
        for p in [self.src, self.out] + self.kept:
            if os.path.exists(p):
                os.unlink(p)

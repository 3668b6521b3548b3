"""A closed loop of a trainer's export: the public filters on a device
cloud, then ``Converter.write_processed`` to one format.

Set-up mints the configuration's scene from the seed as the port's device
cloud and runs one export (which loads the port's kernels).  Each export
of the window runs ``crop_by_bbox``, ``alpha_filter``, ``density_filter``
and ``remove_flyers`` on the card and writes the file; a uniform sample of
the files written, drawn from the seed, is kept and decoded against the
reference's keep-set of the same scene.  A traced export wraps each call
in a span that ends in a synchronize.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from gsbench import common, scene
from gsbench.reference import convert as ref


class Loop:
    def __init__(self, cell, seed: int, device: str, scratch):
        self.cfg, self.mix = cell.config, cell.traffic
        self.limits, self.rules = cell.limits, cell.rules
        self.seed, self.device = seed, torch.device(device)
        self.stages: dict = {}
        self.traced = 0
        fmt = self.mix["format"]
        self.out = os.path.join(scratch, f"out.{fmt}")
        self.kept = [os.path.join(scratch, f"kept{i}.{fmt}")
                     for i in range(int(self.mix["sampled_outputs"]))]

    def setup(self):
        from gsconverter_tpu_torch.converter import Converter
        from gsconverter_tpu_torch.ops import filters, sor

        self.Converter, self.filters, self.sor = Converter, filters, sor
        self.phases = ph = common.Phases()
        minted = scene.mint(self.cfg["scene"], self.seed, self.device)
        ph.mark("mint")
        self.cloud = common.program_cloud(minted, self.cfg["scene"]["sh_degree"])
        self.host = scene.to_host(minted)
        self.sample = common.Reservoir(len(self.kept), self.seed)
        self._export(None)
        ph.mark("an export")

    @contextlib.contextmanager
    def _span(self, name, spans):
        if spans is None:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"gsbench/{name}"):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        spans.setdefault(name, []).append(time.perf_counter() - t0)

    def _export(self, spans):
        f, fl = self.filters, self.cfg["filters"]
        c = self.cloud
        with self._span("bbox", spans):
            c = f.crop_by_bbox(c, fl["bbox"])
        with self._span("alpha", spans):
            c = f.alpha_filter(c, fl["min_opacity"])
        with self._span("density", spans):
            c = f.density_filter(c, sensitivity=fl["density_sensitivity"])
        with self._span("sor", spans):
            c = f.remove_flyers(c, intensity=fl["sor_intensity"], device=self.device)
        with self._span("write", spans):
            self.Converter("", self.out, self.mix["format"], device=self.device) \
                .write_processed(c, **self.mix.get("write", {}))

    def iteration(self):
        self._export(None)
        slot = self.sample.slot()
        if slot is not None:
            os.replace(self.out, self.kept[slot])
            self.sample.items[slot] = self.kept[slot]

    def traced_iteration(self, i):
        self._export(self.stages)
        self.traced += 1

    def counters(self) -> dict:
        return {"k1": self.sor.KERNEL_LAUNCHES}

    def e2e(self, window_s, times) -> dict:
        return {"convert_msplats_s": len(times) * self.cfg["scene"]["splats"] / window_s / 1e6}

    def release(self):
        del self.cloud
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        self.info = ref.keep_rows(self.host, self.cfg["filters"], self.device)
        band = self.rules["sor_band"]
        bad = max(ref.compare_spz(ref.read_spz(p), self.host, self.info, band)
                  for p in [p for p in self.sample.items] or [self.out])
        return common.checks_from({"bad_rows": bad}, self.limits)

    def control(self) -> dict:
        """The compared number with the reference on bfloat16 inputs in the
        program's place (after ``check``), stored as the file stores it."""
        low = common.bf16(self.host)
        kept = ref.keep_rows(low, self.cfg["filters"], self.device)["kept"]
        got = ref.spz_store(low, kept, self.cfg["scene"]["sh_degree"])
        return {"bad_rows": ref.compare_spz(got, self.host, self.info, self.rules["sor_band"])}

    def work(self) -> dict:
        return common.sor_work(self.info, self.traced)

    def close(self):
        for p in [self.out] + self.kept:
            if os.path.exists(p):
                os.unlink(p)

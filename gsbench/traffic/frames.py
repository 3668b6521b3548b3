"""A closed loop of forward frames through the port's ``render``, round
robin over cameras orbiting the configuration's target.

Set-up mints the scene, builds each camera's ``auto_budget`` and renders
one frame a camera.  Each frame of the window runs with no gradient and
ends in a synchronize, as a viewer's does.  A uniform sample of the
window's frames, drawn from the seed, is kept and held against the
reference's frame of its camera.
"""

from __future__ import annotations

import numpy as np
import torch

from gsbench import common, scene
from gsbench.reference import render as ref


class Loop:
    def __init__(self, cell, seed: int, device: str, scratch):
        self.cfg, self.mix, self.limits = cell.config, cell.traffic, cell.limits
        self.rcfg = dict(cell.config["render"], sh_degree=cell.config["scene"]["sh_degree"])
        self.seed, self.device = seed, torch.device(device)
        self.stages: dict = {}
        self.traced_cams: list = []
        self.i = 0

    def setup(self):
        from gsconverter_tpu_torch.render import rasterizer

        cfg, dev = self.cfg, self.device
        self.rz = rasterizer
        self.phases = ph = common.Phases()
        self.true = scene.mint(cfg["scene"], self.seed, dev)
        ph.mark("mint")
        self.cams, self.rcams = common.cameras(cfg["camera"], self.mix["azimuths_deg"], dev)
        cloud = common.program_cloud(self.true, cfg["scene"]["sh_degree"])
        self.cloud = cloud
        self.kw, self.prog_budget, self.prog_glob = [], [], []
        for cam in self.cams:
            kw, per_tile, glob = common.program_budget(cloud, cam, cfg["render"])
            self.kw.append(kw)
            self.prog_budget.append(per_tile)
            self.prog_glob.append(glob)
        ph.mark("auto_budget")
        self.sample = common.Reservoir(int(self.mix["sampled_frames"]), self.seed)
        for c in range(len(self.cams)):
            self._frame(c)
        self._sync()
        ph.mark("a frame a camera")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _frame(self, c):
        with torch.no_grad():
            return self.rz.render(self.cloud, self.cams[c], **self.kw[c])

    def iteration(self):
        c = self.i % len(self.cams)
        self.i += 1
        img = self._frame(c)
        self._sync()
        slot = self.sample.slot()
        if slot is not None:
            self.sample.items[slot] = (c, img)

    def traced_iteration(self, i):
        self.traced_cams.append(self.i % len(self.cams))
        self.iteration()

    def counters(self) -> dict:
        return dict(self.rz.LAUNCHES)

    def e2e(self, window_s, times) -> dict:
        return {"frame_ms": window_s / len(times) * 1e3,
                "frame_p95_ms": float(np.percentile(np.asarray(times), 95)) * 1e3}

    def release(self):
        del self.cloud
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, dtype, work=None):
        out = []
        for c, rcam in enumerate(self.rcams):
            budget, glob = ref.budgets(ref.project(self.true, rcam, self.rcfg["sh_degree"]),
                                       rcam, self.rcfg["budget"], dtype)
            w = {} if work is not None else None
            out.append((budget, glob, ref.render(self.true, rcam, budget, glob, self.rcfg,
                                                 dtype, w)))
            if work is not None:
                work.append(w)
        return out

    def check(self) -> list:
        self._work: list = []
        self.ref_out = self._reference(torch.float32, self._work)
        gap = max(float((img - self.ref_out[c][2]).abs().max())
                  for c, img in self.sample.items)
        diff = sum(common.budget_diff(self.prog_budget[c], self.prog_glob[c], b, g)
                   for c, (b, g, _) in enumerate(self.ref_out))
        return common.checks_from({"frame_gap": gap, "budget_diff": diff}, self.limits)

    def control(self) -> dict:
        low = self._reference(torch.bfloat16)
        gap = max(float((lo[2] - hi[2]).abs().max()) for lo, hi in zip(low, self.ref_out))
        diff = sum(common.budget_diff(lo[0], lo[1], hi[0], hi[1])
                   for lo, hi in zip(low, self.ref_out))
        return {"frame_gap": gap, "budget_diff": diff}

    def work(self) -> dict:
        pixels = self.rcams[0].width * self.rcams[0].height
        total: dict = {}
        for c in self.traced_cams:
            for k, w in common.frame_work(self._work[c], pixels).items():
                acc = total.setdefault(k, {"ops": 0, "bytes": 0})
                acc["ops"] += w["ops"]
                acc["bytes"] += w["bytes"]
        return total

    def close(self):
        pass

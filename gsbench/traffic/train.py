"""A closed loop of Adam steps through the port's ``make_train_step``.

Set-up mints the configuration's scene from the seed, renders the target
frame with the reference (its seconds are left out of ``setup_s``), builds
one training step (the port's camera, ``auto_budget`` and Adam over every
splat parameter, from the perturbed start) and drives it through its
first ``checked_steps`` steps.  The window runs that same step object on,
with no synchronise until its end.  One step of the window, drawn from the
seed (``window_step`` gives the range; in a traced run one of the traced
steps), is recorded whole: the parameters and Adam's moments and counts
before it, its loss and gradients, the parameters after it.

After the window the reference takes the same start, target and budget
through the checked steps (losses, the first gradient from Adam's first
moment after step 1, the change of the parameters), and takes one step
from the recorded state of the window's step.  That step follows the
program from the program's own state: the checked steps check the start
by themselves.
"""

from __future__ import annotations

import math
import time

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
        self.traced = 0
        self.reference_s = 0.0
        self.i = 0
        rng = np.random.default_rng(seed)
        lo, hi = self.mix["window_step"]
        self.k_window = int(rng.integers(lo, hi))
        self.k_traced = int(rng.integers(1, int(self.mix["trace_iterations"])))
        self.recorded = None

    def setup(self):
        from gsconverter_tpu_torch.render import rasterizer, train

        cfg, dev, rcfg = self.cfg, self.device, self.rcfg
        tcfg = cfg["train"]
        self.phases = ph = common.Phases()
        true = scene.mint(cfg["scene"], self.seed, dev)
        ph.mark("mint")
        (cam,), (rcam,) = common.cameras(cfg["camera"], [self.mix["azimuth_deg"]], dev)
        self.rcam = rcam
        t_ref = time.perf_counter()
        with torch.no_grad():
            self.ref_budget, self.ref_glob = ref.budgets(
                ref.project(true, rcam, rcfg["sh_degree"]), rcam, rcfg["budget"])
            self.target = ref.render(true, rcam, self.ref_budget, self.ref_glob, rcfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.reference_s = time.perf_counter() - t_ref
        ph.mark("target frame (reference; not in setup_s)")
        self.true, self.start = true, dict(true)
        for k, d in tcfg["start"].items():
            self.start[k] = true[k] + d
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # the program: its budget from the true scene, one step object
        kw, self.prog_budget, self.prog_glob = common.program_budget(
            common.program_cloud(true, cfg["scene"]["sh_degree"]), cam, rcfg)
        base = common.program_cloud(self.start, cfg["scene"]["sh_degree"])
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in train.params_of(base).items()}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=tcfg["lr"],
                                    betas=tuple(tcfg["betas"]), eps=tcfg["eps"])
        self.step = train.make_train_step(base, cam, self.opt, self.params, **kw)
        ph.mark("auto_budget and step")
        self.launches = rasterizer.LAUNCHES
        losses = []
        for s in range(int(self.mix["checked_steps"])):
            losses.append(self.step(self.target))
            ph.mark(f"step {s + 1}")
            if s == 0:
                b1 = tcfg["betas"][0]
                self.first = {k: (self.opt.state[p]["exp_avg"] / (1 - b1)
                                  if p in self.opt.state else torch.zeros_like(p)).detach().clone()
                              for k, p in self.params.items()}
        self.after = {k: p.detach().clone() for k, p in self.params.items()}
        self.losses = [float(x) for x in losses]

    def _state(self) -> dict:
        """Adam's moments and counts by leaf, copied."""
        out = {}
        for k, p in self.params.items():
            st = self.opt.state.get(p, {})
            out[k] = {"exp_avg": st["exp_avg"].detach().clone() if st else torch.zeros_like(p),
                      "exp_avg_sq": (st["exp_avg_sq"].detach().clone() if st
                                     else torch.zeros_like(p)),
                      "step": st["step"].detach().clone() if st else torch.zeros(())}
        return out

    def _step(self, record: bool):
        if not record:
            self.step(self.target)
            return
        before = {k: p.detach().clone() for k, p in self.params.items()}
        state = self._state()
        loss = self.step(self.target)
        self.recorded = {
            "start": before, "state": state, "loss": loss.detach().clone(),
            "grad": {k: (torch.zeros_like(p) if p.grad is None else p.grad.detach().clone())
                     for k, p in self.params.items()},
            "after": {k: p.detach().clone() for k, p in self.params.items()}}

    def iteration(self):
        self._step(self.i == self.k_window)
        self.i += 1

    def traced_iteration(self, i):
        self._step(self.i == self.k_traced)
        self.i += 1
        self.traced += 1

    def counters(self) -> dict:
        return dict(self.launches)

    def e2e(self, window_s, times) -> dict:
        return {"train_step_ms": window_s / len(times) * 1e3}

    def release(self):
        del self.step, self.opt, self.params
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, budget, glob, dtype, work=None):
        losses, first, after = ref.adam_steps(
            self.start, self.target, self.rcam, budget, glob, self.rcfg, self.cfg["train"],
            int(self.mix["checked_steps"]), dtype, work)
        return {"losses": losses, "first": first, "after": after, "start": self.start}

    def _reference_window(self, budget, glob, dtype):
        """One reference step from the recorded state of the window's step."""
        rec = self.recorded
        state = {k: dict(v, step=int(v["step"])) for k, v in rec["state"].items()}
        losses, grad, after = ref.adam_steps(
            rec["start"], self.target, self.rcam, budget, glob, self.rcfg, self.cfg["train"],
            1, dtype, state=state)
        return {"losses": losses, "first": grad, "after": after, "start": rec["start"]}

    def _window_numbers(self, got: dict, want: dict) -> dict:
        return {f"window_{k}": v for k, v in common.train_numbers(got, want).items()}

    def check(self) -> list:
        self._work: dict = {}
        self.ref_out = self._reference(self.ref_budget, self.ref_glob, torch.float32,
                                       self._work)
        prog = {"losses": self.losses, "first": self.first, "after": self.after,
                "start": self.start}
        numbers = dict(common.train_numbers(prog, self.ref_out),
                       budget_diff=common.budget_diff(self.prog_budget, self.prog_glob,
                                                      self.ref_budget, self.ref_glob))
        if self.recorded is None:
            # the run ended before the drawn step: nothing to compare
            numbers.update(window_loss_rel=math.inf, window_grad_norm_gap=math.inf,
                           window_change_norm_gap=math.inf)
        else:
            rec = self.recorded
            self.ref_window = self._reference_window(self.ref_budget, self.ref_glob,
                                                     torch.float32)
            got = {"losses": [float(rec["loss"])], "first": rec["grad"],
                   "after": rec["after"], "start": rec["start"]}
            numbers.update(self._window_numbers(got, self.ref_window))
        return common.checks_from(numbers, self.limits)

    def control(self) -> dict:
        """The compared numbers with the reference in bfloat16 in the
        program's place (after ``check``)."""
        with torch.no_grad():
            budget, glob = ref.budgets(ref.project(self.true, self.rcam, self.rcfg["sh_degree"]),
                                       self.rcam, self.rcfg["budget"], torch.bfloat16)
        low = self._reference(budget, glob, torch.bfloat16)
        out = dict(common.train_numbers(low, self.ref_out),
                   budget_diff=common.budget_diff(budget, glob, self.ref_budget, self.ref_glob))
        if self.recorded is not None:
            out.update(self._window_numbers(self._reference_window(budget, glob, torch.bfloat16),
                                            self.ref_window))
        return out

    def work(self) -> dict:
        per = common.frame_work(self._work, self.rcam.width * self.rcam.height)
        return {k: {q: v * self.traced for q, v in w.items()} for k, w in per.items()}

    def close(self):
        pass

"""Faults of a training loop.  A fault named ``late_<fault>`` starts only
after the cell's checked steps, as a step cached or captured after warm-up
would go wrong: the window's recorded step is what must catch it."""

from __future__ import annotations

import torch

from gsbench.faults import _from_call

FAULTS = ("state_unchanged", "half_batch", "answer_altered",
          "late_state_unchanged", "late_half_batch", "late_answer_altered")


def plant(cell, fault, patch):
    from gsconverter_tpu_torch.render import train

    after = 0
    if fault.startswith("late_"):
        fault, after = fault[len("late_"):], int(cell.traffic["checked_steps"])
    orig = train.render
    if fault == "state_unchanged":
        patch(torch.optim.Adam, "step",
              _from_call(after, torch.optim.Adam.step, lambda self, closure=None: None))
    elif fault == "half_batch":
        def render(*a, **k):
            img = orig(*a, **k)
            h = img.shape[0] // 2
            return torch.cat([img[:h], img[h:].detach()])  # half the pixels give no gradient
        patch(train, "render", _from_call(after, orig, render))
    elif fault == "answer_altered":
        patch(train, "render", _from_call(after, orig, lambda *a, **k: orig(*a, **k) * 1.01))
    else:
        raise KeyError(fault)

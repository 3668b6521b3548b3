"""Faults planted under a cell's timed path, each of which ``correct`` must
catch.  ``plant(cell, fault, patch)`` breaks the port through
``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
``Patches``): a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced.  A training fault named
``late_<fault>`` starts only after the cell's checked steps, as a step
cached or captured after warm-up would go wrong.  The tests plant them at
a small size on the CPU; ``calibrate.py --fault`` on the card at the
cell's own size.  The benchmark's own runs never do."""

from __future__ import annotations

import numpy as np
import torch


def _from_call(after: int, good, bad):
    """``good`` for the first ``after`` calls, ``bad`` from then on."""
    calls = [0]

    def f(*a, **k):
        calls[0] += 1
        return (bad if calls[0] > after else good)(*a, **k)
    return f


def _train(cell, fault, patch):
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


def _frames(cell, fault, patch):
    from gsconverter_tpu_torch.render import rasterizer

    orig = rasterizer.render

    def render(*a, **k):
        img = orig(*a, **k).clone()
        if fault == "half_batch":
            img[img.shape[0] // 2:] = 0.0
        else:
            img[3, 5, 1] += 0.01
        return img
    if fault not in ("half_batch", "answer_altered"):
        raise KeyError(fault)
    patch(rasterizer, "render", render)


def _writer(fmt):
    def plant(cell, fault, patch):
        from gsconverter_tpu_torch.formats import get_handler

        cls = type(get_handler(fmt))
        orig = cls.write

        def write(self, cloud, path, **kw):
            if fault == "half_batch":
                half = (np.arange(cloud.n // 2) if cloud.is_host
                        else torch.arange(cloud.n // 2, device=cloud.pos.device))
                cloud = cloud.select(half)
            else:
                pos = cloud.pos.copy() if cloud.is_host else cloud.pos.clone()
                pos[0, 0] += 0.01
                cloud = cloud.replace(pos=pos)
            return orig(self, cloud, path, **kw)
        if fault not in ("half_batch", "answer_altered"):
            raise KeyError(fault)
        patch(cls, "write", write)
    return plant


KINDS = {"train": _train, "frames": _frames, "convert": _writer("splat"),
         "export": _writer("spz")}
#: the faults each kind of cell can have (one chip: no exchange to leave out)
FAULTS = {"train": ("state_unchanged", "half_batch", "answer_altered",
                   "late_state_unchanged", "late_half_batch", "late_answer_altered"),
          "frames": ("half_batch", "answer_altered"),
          "convert": ("half_batch", "answer_altered"),
          "export": ("half_batch", "answer_altered")}


def plant(cell, fault: str, patch) -> None:
    KINDS[cell.traffic["kind"]](cell, fault, patch)


class Patches:
    """``patch(obj, name, value)`` undone by ``undo()``."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()

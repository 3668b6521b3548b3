"""Faults planted under a cell's timed path, each of which ``correct`` must
catch.  ``plant(cell, fault, patch)`` breaks the port through
``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
``Patches``): a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced.  The tests plant them at
a small size on the CPU; ``calibrate.py --fault`` on the card at the
cell's own size.  The benchmark's own runs never do.

Each kind of traffic brings its faults in ``gsbench/faults/<kind>.py``,
found by name as its loop is (``gsbench/traffic/<kind>.py``): ``FAULTS``,
the names of the faults the kind's cells can have, and ``plant(cell,
fault, patch)``.  A kind without that file has no faults; the tests say
which file is missing.
"""

from __future__ import annotations

from pathlib import Path
from types import ModuleType

import numpy as np
import torch

from gsbench import spec


def _from_call(after: int, good, bad):
    """``good`` for the first ``after`` calls, ``bad`` from then on."""
    calls = [0]

    def f(*a, **k):
        calls[0] += 1
        return (bad if calls[0] > after else good)(*a, **k)
    return f


def in_writer(fmt: str, fault: str, patch) -> None:
    """``fault`` in the port's ``fmt`` writer: half of the rows it is given
    left out, or one position altered before it writes."""
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


def path(kind: str, root: Path = spec.ROOT) -> Path:
    """``gsbench/faults/<kind>.py``."""
    return root / "gsbench" / "faults" / f"{kind}.py"


def module(kind: str, root: Path = spec.ROOT) -> ModuleType | None:
    """The kind's faults module, or None where it brings none."""
    p = path(kind, root)
    return spec.load_module(p, f"gsbench_faults_{kind}") if p.is_file() else None


def names(kind: str, root: Path = spec.ROOT) -> tuple:
    """The faults a cell of ``kind`` can have (none without its file)."""
    mod = module(kind, root)
    return tuple(mod.FAULTS) if mod is not None else ()


def plant(cell, fault: str, patch, root: Path = spec.ROOT) -> None:
    kind = cell.traffic["kind"]
    mod = module(kind, root)
    if mod is None:
        raise FileNotFoundError(f"{path(kind, root)}: the kind {kind!r} brings no faults")
    mod.plant(cell, fault, patch)


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

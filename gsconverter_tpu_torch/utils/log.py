"""Logging / progress utilities.

Reproduces the user-facing reporting contract of the reference: a gated
``debug_print`` and an always-on, tqdm-safe ``status_print``, plus
per-stage timing (``StageTimer``) whose stages show up as named ranges in a
``torch.profiler`` trace.  tqdm is optional: without it, progress is a
no-op object and messages go to ``print``.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .. import config


def debug_print(msg: str) -> None:
    """Print only when debug mode is on (mirrors reference debug_print)."""
    if config.DEBUG:
        _safe_write(msg)


def status_print(msg: str) -> None:
    """Always print, routed through tqdm.write when tqdm is installed."""
    _safe_write(msg)


def _safe_write(msg: str) -> None:
    try:
        from tqdm import tqdm
    except ImportError:
        print(msg)
        return
    tqdm.write(str(msg))


class _NoProgress:
    """Stand-in for a tqdm bar where tqdm is not installed."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def update(self, n: int = 1) -> None:
        pass

    def set_description(self, desc: str) -> None:
        pass

    def refresh(self) -> None:
        pass


def progress(total: int, desc: str, bar_format: str):
    """A tqdm progress bar, or a no-op one where tqdm is not installed."""
    try:
        from tqdm import tqdm
    except ImportError:
        return _NoProgress()
    return tqdm(total=total, desc=desc, bar_format=bar_format)


class StageTimer:
    """Per-stage wall-clock timing + throughput reporting.

    A stage's time is host wall-clock; stages that launch device work end
    in a host readback of their result, so the time covers the device work.
    """

    def __init__(self) -> None:
        self.records: list[tuple[str, float, int | None]] = []

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int | None = None):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"gsconverter/{name}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.records.append((name, dt, n_items))
            if config.TIMING:
                rate = f" ({n_items / dt / 1e6:.2f} Msplats/s)" if n_items else ""
                status_print(f"[timing] {name}: {dt * 1e3:.1f} ms{rate}")

    def report(self) -> dict[str, float]:
        return {name: dt for name, dt, _ in self.records}

"""Millions of window slots a frame: tiles x padded budget over the bands."""

from gsbench.spans import count_per_root


def read(tr):
    return count_per_root(("render",), "window_slots", 1e-6)

"""Millions of window slots a step: tiles x padded budget over the bands."""

from gsbench.spans import count_per_root


def read(tr):
    return count_per_root(("train_step",), "window_slots", 1e-6)

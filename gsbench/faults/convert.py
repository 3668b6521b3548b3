"""Faults of a conversion loop, in the ``.splat`` writer it ends in."""

from __future__ import annotations

from gsbench.faults import in_writer

FAULTS = ("half_batch", "answer_altered")


def plant(cell, fault, patch):
    in_writer("splat", fault, patch)

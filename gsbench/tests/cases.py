"""What the benchmark's CPU tests share: the cells of ``BENCHMARK.json``,
the faults each can have, and a whole run of a cell at its tiny size on the
CPU (``gsbench/tiny.py``), the harness's look for a card skipped."""

import time

import torch

from gsbench import faults, spec
from gsbench.run import execute

# a few threads a test process: several run side by side
torch.set_num_threads(2)

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 7


def kind(name: str) -> str:
    return spec.cell(BENCH, name).traffic["kind"]


#: (cell, fault) for every fault of every cell's kind; a kind without its
#: faults file gives none here, and fails the spec tests
FAULT_CASES = [(name, fault) for name in CELLS for fault in faults.names(kind(name))]


def run(cell, scratch, on_checked=None):
    return execute(cell, SEED, 0.5, False, "cpu", scratch, time.perf_counter(),
                   on_checked=on_checked)


def over(numbers: dict, limits: dict) -> list:
    """The compared numbers past their limits."""
    return [k for k, v in numbers.items() if not v <= limits[k]]

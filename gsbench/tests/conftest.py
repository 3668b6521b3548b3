"""The benchmark's CPU tests: the checkout's root on the import path, and
tiny versions of the cells that a test run can hold."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# splats and frame of each configuration at the tests' size: large enough
# that SOR takes kernel K1's route (8192 points or more enter it) and that
# tiles hold overlapping splats, small enough for the CPU
# a few threads a test process: several run side by side
torch.set_num_threads(2)

TINY = {"c4-render-1m-1080p": dict(splats=3000, width=128, height=64),
        "c2-filter-chain-1m": dict(splats=30000)}


def tiny_cell(name):
    from gsbench import spec

    cell = spec.cell(spec.load_benchmark(), name)
    cfg = copy.deepcopy(cell.config)
    size = TINY[cell.config_name]
    cfg["scene"]["splats"] = size["splats"]
    if "camera" in cfg:
        cfg["camera"].update(width=size["width"], height=size["height"])
    cell.config = cfg
    if "window_step" in cell.traffic:
        # the recorded step is the window's first: a short window on the CPU
        # holds a step or two
        cell.traffic = dict(cell.traffic, window_step=[0, 1])
    return cell


@pytest.fixture
def tiny():
    return tiny_cell

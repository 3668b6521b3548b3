"""Cells at the CPU tests' size.

A configuration or a mix may carry a ``tiny`` object, whose values take
the place of its own (nested objects merged key by key, anything else
replaced): the configuration's scene and frame at a size a test run can
hold, a mix's settings that a window of a second cannot reach.  A run never
reads it (``spec.cell`` drops it); ``tiny_cell`` merges it in.
"""

from __future__ import annotations

import copy
from pathlib import Path

from gsbench import spec


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s values in its place, nested objects merged."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def tiny_cell(name: str, root: Path = spec.ROOT) -> spec.Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, its
    configuration and mix sized by their ``tiny`` objects."""
    bench = spec.load_benchmark(root / "BENCHMARK.json")
    cell = spec.cell(bench, name, root)
    _, cfg_tiny = spec.read_sized(spec.config_file(bench, cell.config_name, root))
    _, mix_tiny = spec.read_sized(spec.traffic_file(cell.traffic_name, root))
    cell.config = merged(cell.config, cfg_tiny)
    cell.traffic = merged(cell.traffic, mix_tiny)
    return cell

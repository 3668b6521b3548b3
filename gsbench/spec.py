"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration is the JSON file its ``configs`` entry gives; the mix is
``gsbench/traffic/<traffic>.json``, whose ``kind`` names the loop that
drives the port (``gsbench/traffic/<kind>.py``).  The limits of the numbers
that decide ``correct`` were read for one cell and belong to it:
``gsbench/limits/<cell>.json``.  A per-layer metric is read by
``gsbench/metrics/<name>.py``, and the faults a kind of traffic can have
are planted by ``gsbench/faults/<kind>.py``.  Everything is found by name,
so a later cell, configuration, kind of traffic or metric is a matter of
adding files.

A configuration or a mix may carry a ``tiny`` object: what the CPU tests
size down (``gsbench/tiny.py``).  ``cell`` drops it, so a run never reads
it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

GSBENCH = Path(__file__).resolve().parent
ROOT = GSBENCH.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict  # compared number -> its limit
    rules: dict  # the rest of the cell's limits file (what the check leaves out)
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def reports(metric: dict, cell: str, e2e_names: set[str] | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists, or, without the key, every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def config_file(bench: dict, config: str, root: Path = ROOT) -> Path:
    return root / _by_name(bench["configs"], config, "config")["file"]


def traffic_file(traffic: str, root: Path = ROOT) -> Path:
    return root / "gsbench" / "traffic" / f"{traffic}.json"


def read_sized(path: Path) -> tuple[dict, dict]:
    """A configuration or mix as a run reads it, and its ``tiny`` object
    (empty where it has none)."""
    with open(path) as f:
        data = json.load(f)
    return data, data.pop("tiny", {})


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    w = _by_name(bench["workloads"], name, "workload")
    cfg, _ = read_sized(config_file(bench, w["config"], root))
    mix, _ = read_sized(traffic_file(w["traffic"], root))
    with open(root / "gsbench" / "limits" / f"{name}.json") as f:
        rules = json.load(f)
    limits = rules.pop("limits")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"], config=cfg,
                traffic_name=w["traffic"], traffic=mix, limits=limits, rules=rules,
                end_to_end=e2e,
                per_layer=per_layer)


def load_module(path: Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_loop(kind: str, root: Path = ROOT) -> ModuleType:
    """``gsbench/traffic/<kind>.py``: the loop of one kind of traffic."""
    return load_module(root / "gsbench" / "traffic" / f"{kind}.py", f"gsbench_traffic_{kind}")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``gsbench/metrics/<name>.py``: its ``read(trace)`` returns the value
    or None where the trace holds nothing to read."""
    return load_module(root / "gsbench" / "metrics" / f"{name}.py",
                       "gsbench_metric_" + name.replace(".", "_").replace("-", "_"))


def check_names(bench: dict) -> list[str]:
    """Names and units outside the allowed characters (empty when sound)."""
    bad = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[key]:
            if not NAME_RE.fullmatch(e["name"]):
                bad.append(f"{key}: name {e['name']!r}")
            if "unit" in e and not UNIT_RE.fullmatch(e["unit"]):
                bad.append(f"{key}: unit {e['unit']!r}")
            for k in ("config", "traffic"):
                if k in e and not NAME_RE.fullmatch(e[k]):
                    bad.append(f"{key}: {k} {e[k]!r}")
            for k in e.get("reduced", []):
                if not NAME_RE.fullmatch(k):
                    bad.append(f"{key}: reduced key {k!r}")
    return bad

"""BENCHMARK.json and the files it names: every name resolves, every name
and unit is well formed, each configuration and mix is read at full size as
before and sized down by its own ``tiny``, and a cell of a new
configuration and a new kind of traffic, with its faults, limits and a
tensor-core roofline reader, is added as files alone."""

import copy
import dataclasses
import hashlib
import json
import shutil
import subprocess
import sys
import types

import pytest

from gsbench import faults, spec, trace
from gsbench.tiny import merged, tiny_cell

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units_use_only_allowed_characters():
    assert spec.check_names(BENCH) == []


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = spec.cell(BENCH, name)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert {m["moves"] for m in cell.per_layer} <= set(e2e)
    kind = cell.traffic["kind"]
    loop_module = spec.traffic_loop(kind)
    for method in ("setup", "iteration", "traced_iteration", "check", "control", "work", "e2e"):
        assert callable(getattr(loop_module.Loop, method))
    assert set(cell.limits) and cell.chips in (1, 4)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    assert faults.path(kind).is_file(), f"{faults.path(kind)} is missing: no faults of {kind!r}"
    assert faults.names(kind)


def test_every_metric_has_a_reader_and_every_config_a_source():
    for m in BENCH["per_layer"]:
        assert (spec.GSBENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def _digest(d: dict) -> str:
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()


# each configuration and mix as a run read it before the files carried
# ``tiny`` (sha256 of its JSON with sorted keys)
FULL_SIZE = {
    "c2-filter-chain-1m": "61cf4d38dbfc5cc611629e6f7bc28b376907dce9e301bd05f40b5f2b3829ec20",
    "c4-render-1m-1080p": "4c4ea138b1e3863613948ecb98b64422a5bbcc61c0c4f07b2e24cb3d5bb66959",
    "convert-splat": "b21f5e908f559e7433f7a2f728bca043603679e8370dd0b804051321502ffd2a",
    "frames-4view": "8309bb19d3104937c9d1f7a29f441efbd26eb0c2c2540d65fd42f7f73d05a627",
    "train-adam-1view": "e3fa9c23fccd2a9fb6c6b5e11d0f014ed57367858d6f726a62438790ff00e736"}

# the tests' sizes when they were a table of their own: each cell sized so
TINY_BEFORE = {"c4-render-1m-1080p": dict(splats=3000, width=128, height=64),
               "c2-filter-chain-1m": dict(splats=30000)}


def _tiny_before(name):
    cell = spec.cell(BENCH, name)
    cfg = copy.deepcopy(cell.config)
    size = TINY_BEFORE[cell.config_name]
    cfg["scene"]["splats"] = size["splats"]
    if "camera" in cfg:
        cfg["camera"].update(width=size["width"], height=size["height"])
    cell.config = cfg
    if "window_step" in cell.traffic:
        cell.traffic = dict(cell.traffic, window_step=[0, 1])
    return cell


# the cells that were there when the sizes were a table
BEFORE = ["c4-train-adam", "c2-convert-splat", "c4-frames-4view"]


@pytest.mark.parametrize("name", BEFORE)
def test_a_run_reads_each_configuration_and_mix_at_full_size_as_before(name, tmp_path):
    cell = spec.cell(BENCH, name)
    assert _digest(cell.config) == FULL_SIZE[cell.config_name]
    assert _digest(cell.traffic) == FULL_SIZE[cell.traffic_name]
    # the loop is handed those same objects
    loop = spec.traffic_loop(cell.traffic["kind"]).Loop(cell, 1, "cpu", tmp_path)
    assert loop.cfg is cell.config and loop.mix is cell.traffic


@pytest.mark.parametrize("name", BEFORE)
def test_tiny_cell_sizes_each_cell_as_the_table_before_did(name):
    assert dataclasses.asdict(tiny_cell(name)) == dataclasses.asdict(_tiny_before(name))


@pytest.mark.parametrize("name", CELLS)
def test_no_run_reads_tiny(name):
    cell = spec.cell(BENCH, name)
    assert "tiny" not in cell.config and "tiny" not in cell.traffic
    tiny = tiny_cell(name)
    assert tiny.limits == cell.limits and tiny.end_to_end == cell.end_to_end


def test_merged_merges_nested_objects_and_replaces_the_rest():
    base = {"scene": {"splats": 10, "sh": 3}, "window_step": [20, 200], "fmt": "splat"}
    got = merged(base, {"scene": {"splats": 2}, "window_step": [0, 1]})
    assert got == {"scene": {"splats": 2, "sh": 3}, "window_step": [0, 1], "fmt": "splat"}
    assert base["scene"]["splats"] == 10


# ---------------------------------------------------------------- a cell added as files

NEW_CONFIG, NEW_CELL, NEW_KIND, NEW_MIX = "cx-filter-chain-1m", "cx-convert-tc", "convert_tc", \
    "convert-tc"

LOOP = '''"""Conversions as ``convert.py`` drives them, whose work also counts a
kernel's tensor-core operations: a kind of traffic of its own files."""

from gsbench import spec

_convert = spec.traffic_loop("convert")


class Loop(_convert.Loop):
    def work(self):
        out = super().work()
        out["kx"] = {"ops": 0, "bytes": 0,
                     "tc_flops": 6.0 * self.info["sor_pairs"] * self.traced}
        return out
'''

FAULTS = '''"""Faults of the new kind, in the writer its conversions end in."""

from gsbench.faults import in_writer

FAULTS = ("answer_altered", "half_batch")


def plant(cell, fault, patch):
    in_writer("splat", fault, patch)
'''

TC_READER = '''"""A tensor-core kernel's share of its roofline."""

from gsbench.trace import roofline_share


def read(tr):
    return roofline_share(tr, "kx_kernel", "kx", "kx")
'''

COUNT_READER = '''"""Conversions in the traced stretch."""


def read(tr):
    return tr.iterations
'''


def _hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """A copy of the benchmark, then the files and entries of a new cell:
    a configuration with its own ``tiny``, a mix of a new kind with its
    loop, its faults, the cell's limits, two per-layer readers."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(spec.GSBENCH, root / "gsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _hashes(root / "gsbench")
    g = root / "gsbench"
    cfg = json.loads((g / "configs" / "c2-filter-chain-1m.json").read_text())
    cfg.update(name=NEW_CONFIG, tiny={"scene": {"splats": 20000}})
    (g / "configs" / f"{NEW_CONFIG}.json").write_text(json.dumps(cfg))
    mix = json.loads((g / "traffic" / "convert-splat.json").read_text())
    mix.update(kind=NEW_KIND, tiny={"sampled_outputs": 1})
    (g / "traffic" / f"{NEW_MIX}.json").write_text(json.dumps(mix))
    (g / "traffic" / f"{NEW_KIND}.py").write_text(LOOP)
    (g / "faults" / f"{NEW_KIND}.py").write_text(FAULTS)
    (g / "limits" / f"{NEW_CELL}.json").write_text(
        json.dumps({"limits": {"bad_rows": 0}, "sor_band": 0.03}))
    (g / "metrics" / "kx_roofline.tc.py").write_text(TC_READER)
    (g / "metrics" / "conversions.convert.py").write_text(COUNT_READER)
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": NEW_CONFIG, "source": cfg["source"],
                             "file": f"gsbench/configs/{NEW_CONFIG}.json", "reduced": [],
                             "why": "a new configuration"})
    bench["workloads"].append({"name": NEW_CELL, "config": NEW_CONFIG, "traffic": NEW_MIX,
                               "chips": 1, "why": "a new kind of traffic"})
    for m in bench["end_to_end"]:
        if m["name"] == "convert_msplats_s":
            m["workloads"].append(NEW_CELL)
    bench["per_layer"] += [
        {"name": "kx_roofline.tc", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "Kernels", "moves": "convert_msplats_s", "workloads": [NEW_CELL]},
        # without ``workloads``: read in every cell of its end-to-end metric
        {"name": "conversions.convert", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "Device", "moves": "convert_msplats_s"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return types.SimpleNamespace(root=root, before=before, after=_hashes(root / "gsbench"),
                                 bench=spec.load_benchmark(root / "BENCHMARK.json"))


def test_a_cell_added_as_files_alone_is_found(added):
    # no file of the benchmark changed: the new ones were added beside them
    assert {k: added.after[k] for k in added.before} == added.before
    assert set(added.after) - set(added.before) == {
        f"configs/{NEW_CONFIG}.json", f"traffic/{NEW_MIX}.json", f"traffic/{NEW_KIND}.py",
        f"faults/{NEW_KIND}.py", f"limits/{NEW_CELL}.json", "metrics/kx_roofline.tc.py",
        "metrics/conversions.convert.py"}
    # BENCHMARK.json only gained entries, and a cell in a metric's ``workloads``
    for key, entries in BENCH.items():
        if not isinstance(entries, list) or not entries or not isinstance(entries[0], dict):
            assert added.bench[key] == entries
            continue
        for old, new in zip(entries, added.bench[key]):
            assert {k: v for k, v in new.items() if k != "workloads"} == \
                {k: v for k, v in old.items() if k != "workloads"}
            assert new.get("workloads", [])[:len(old.get("workloads", []))] == \
                old.get("workloads", [])
    assert spec.check_names(added.bench) == []
    cell = spec.cell(added.bench, NEW_CELL, root=added.root)
    assert cell.config_name == NEW_CONFIG and cell.config["scene"]["splats"] == 1000000
    assert "tiny" not in cell.config and "tiny" not in cell.traffic
    assert cell.limits == {"bad_rows": 0} and cell.rules == {"sor_band": 0.03}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "convert_msplats_s"]
    assert [m["name"] for m in cell.per_layer] == ["kx_roofline.tc", "conversions.convert"]
    # a per-layer metric without ``workloads`` is read in the older cells too
    assert "conversions.convert" in [m["name"] for m in spec.cell(
        added.bench, "c2-convert-splat", root=added.root).per_layer]
    tiny = tiny_cell(NEW_CELL, root=added.root)
    assert tiny.config["scene"]["splats"] == 20000 and tiny.traffic["sampled_outputs"] == 1
    assert tiny.config["filters"] == cell.config["filters"]
    assert faults.names(NEW_KIND, root=added.root) == ("answer_altered", "half_batch")
    assert hasattr(spec.traffic_loop(NEW_KIND, root=added.root), "Loop")


def test_a_reader_added_as_a_file_reads_the_tensor_core_bound(added):
    read = spec.metric_reader("kx_roofline.tc", root=added.root).read
    tr = trace.Trace(iterations=2, window_s=0.01,
                     device=[("kx_kernel<3>(float const*)", 0.0, 500.0),
                             ("kx_kernel<3>(float const*)", 1000.0, 500.0)],
                     host=[], launches={"kx": 2},
                     work={"kx": {"ops": 33.5e6, "bytes": 3.35e6, "tc_flops": 9.89e9}})
    # 1 us of FP32 instructions or of bytes, 10 us on the tensor cores, over 1 ms
    assert read(tr) == pytest.approx(1.0, rel=1e-12)
    del tr.work["kx"]["tc_flops"]
    assert read(tr) == pytest.approx(0.1, rel=1e-12)
    tr.launches["kx"] = 3
    assert read(tr) is None


def test_a_cell_added_as_files_alone_runs_correct_and_its_faults_do_not(added):
    """In a child process whose ``gsbench`` is the copy's: a tiny sound run
    is correct, traced too, and each fault of the new kind is not."""
    code = f"""
import json, pathlib, sys, tempfile, time
sys.path.insert(1, {str(spec.ROOT)!r})
import torch
torch.set_num_threads(2)
import gsbench
from gsbench import faults
from gsbench.run import execute
from gsbench.tiny import tiny_cell

def go(traced=False):
    with tempfile.TemporaryDirectory() as d:
        return execute(tiny_cell({NEW_CELL!r}), 2**31 + 11, 0.3, traced, "cpu",
                       pathlib.Path(d), time.perf_counter())

out = {{"gsbench": str(pathlib.Path(gsbench.__file__).parent)}}
r = go()
out["sound"] = [r["correct"], r["attempted"], sorted(r["metrics"])]
r = go(True)
out["traced"] = [r["correct"], r["metrics"]]
patches = faults.Patches()
for fault in faults.names({NEW_KIND!r}):
    faults.plant(tiny_cell({NEW_CELL!r}), fault, patches)
    out[fault] = go()["correct"]
    patches.undo()
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=added.root, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["gsbench"] == str(added.root / "gsbench")
    correct, attempted, metrics = out["sound"]
    assert correct and attempted >= 1 and metrics == ["convert_msplats_s", "setup_s"]
    # on the CPU the trace holds no kernel: the roofline reads nothing
    assert out["traced"] == [True, {"conversions.convert": {"value": 3.0, "unit": "count"}}]
    assert out["answer_altered"] is False and out["half_batch"] is False


def test_a_cell_without_its_own_limits_is_refused(tmp_path):
    """Limits were read for one cell: a new cell on an old mix brings its own."""
    shutil.copytree(spec.GSBENCH, tmp_path / "gsbench")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "c4-train-adam-b", "config": "c4-render-1m-1080p",
                               "traffic": "train-adam-1view", "chips": 1, "why": "again"})
    with pytest.raises(FileNotFoundError):
        spec.cell(bench, "c4-train-adam-b", root=tmp_path)

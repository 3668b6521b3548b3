"""BENCHMARK.json and the files it names: every name resolves, every name
and unit is well formed, and a cell added as files alone is found."""

import json
import shutil

import pytest

from gsbench import spec

BENCH = spec.load_benchmark()


def test_names_and_units_use_only_allowed_characters():
    assert spec.check_names(BENCH) == []


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = spec.cell(BENCH, name)
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert {m["moves"] for m in cell.per_layer} <= set(e2e)
    loop_module = spec.traffic_loop(cell.traffic["kind"])
    for method in ("setup", "iteration", "traced_iteration", "check", "control", "work", "e2e"):
        assert callable(getattr(loop_module.Loop, method))
    assert set(cell.limits) and cell.chips == 1
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)


def test_every_metric_has_a_reader_and_every_config_a_source():
    for m in BENCH["per_layer"]:
        assert (spec.GSBENCH / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later cell: a new traffic file and new entries in BENCHMARK.json;
    no file that is there is edited."""
    shutil.copytree(spec.GSBENCH, tmp_path / "gsbench")
    mix = json.loads((spec.GSBENCH / "traffic" / "frames-4view.json").read_text())
    mix["azimuths_deg"] = [45.0]
    (tmp_path / "gsbench" / "traffic" / "frames-1view.json").write_text(json.dumps(mix))
    (tmp_path / "gsbench" / "limits" / "c4-frames-1view.json").write_text(
        json.dumps({"limits": {"frame_gap": 1e-3, "budget_diff": 0}}))
    (tmp_path / "gsbench" / "metrics" / "frame_count.frame.py").write_text(
        "def read(tr):\n    return tr.iterations\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "c4-frames-1view", "config": "c4-render-1m-1080p",
                               "traffic": "frames-1view", "chips": 1, "why": "one view"})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("c4-frames-1view")
    bench["per_layer"].append({"name": "frame_count.frame", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "Device", "moves": "frame_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = spec.load_benchmark(tmp_path / "BENCHMARK.json")
    cell = spec.cell(loaded, "c4-frames-1view", root=tmp_path)
    assert cell.traffic["azimuths_deg"] == [45.0]
    assert "frame_count.frame" in [m["name"] for m in cell.per_layer]
    # a per-layer metric without ``workloads`` is read in every cell of its
    # end-to-end metric, the older ones too
    assert "frame_count.frame" in [m["name"] for m in
                                   spec.cell(loaded, "c4-frames-4view", root=tmp_path).per_layer]
    assert spec.metric_reader("frame_count.frame", root=tmp_path).read(
        type("T", (), {"iterations": 7})()) == 7
    assert hasattr(spec.traffic_loop(cell.traffic["kind"], root=tmp_path), "Loop")
    assert cell.limits == {"frame_gap": 1e-3, "budget_diff": 0}


def test_a_cell_without_its_own_limits_is_refused(tmp_path):
    """Limits were read for one cell: a new cell on an old mix brings its own."""
    shutil.copytree(spec.GSBENCH, tmp_path / "gsbench")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "c4-train-adam-b", "config": "c4-render-1m-1080p",
                               "traffic": "train-adam-1view", "chips": 1, "why": "again"})
    with pytest.raises(FileNotFoundError):
        spec.cell(bench, "c4-train-adam-b", root=tmp_path)

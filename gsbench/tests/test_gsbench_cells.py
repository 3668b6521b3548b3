"""Whole runs of each cell at its tiny size on the CPU: the harness's look
for a card skipped, the rest of a run driven.  A sound run is correct; the
control (the reference in bfloat16 in the program's place) is not.  The
faults planted under the timed path are ``test_gsbench_faults.py``'s.

The check that a run loads neither JAX nor the JAX package runs in a child
process, so it holds whatever the test process itself imported (the
repository's ``tests/conftest.py`` imports JAX)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gsbench import spec
from gsbench.tests.cases import CELLS, over, run
from gsbench.tiny import tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_its_control_is_not(name, tmp_path):
    cell = tiny_cell(name)
    control = {}
    out = run(cell, tmp_path, lambda loop: control.update(loop.control()))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert over(control, cell.limits), control


def _child(code):
    return subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=600)


def test_a_run_without_a_card_prints_no_result():
    res = subprocess.run([sys.executable, "gsbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.parametrize("name", ["c4-train-adam", "c2-convert-splat"])
def test_a_run_loads_neither_jax_nor_the_jax_package(name):
    code = f"""
import json, sys, time, tempfile, pathlib
import torch
torch.set_num_threads(2)
from gsbench.tiny import tiny_cell
from gsbench.run import execute, forbidden_modules
with tempfile.TemporaryDirectory() as d:
    out = execute(tiny_cell({name!r}), 3, 0.2, False, "cpu", pathlib.Path(d), time.perf_counter())
print(json.dumps([out["correct"], forbidden_modules(),
                  "gsconverter_tpu_torch" in sys.modules]))
"""
    res = _child(code)
    assert res.returncode == 0, res.stderr[-3000:]
    correct, found, port = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and found == [] and port


@pytest.mark.cuda
def test_a_cell_on_the_card_prints_a_correct_result():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, "gsbench/run.py", "--workload", "c4-train-adam",
                          "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"

"""Each fault of each cell's kind (``gsbench/faults/<kind>.py``), planted
under the timed path of a tiny run on the CPU, makes ``correct`` false."""

import pytest

from gsbench import faults
from gsbench.tests.cases import FAULT_CASES, run
from gsbench.tiny import tiny_cell

# the faults of the kinds when they were one closed table: each must still
# be planted, under the same name
BEFORE = {"train": ("state_unchanged", "half_batch", "answer_altered",
                    "late_state_unchanged", "late_half_batch", "late_answer_altered"),
          "frames": ("half_batch", "answer_altered"),
          "convert": ("half_batch", "answer_altered")}


@pytest.mark.parametrize("name,fault", FAULT_CASES)
def test_a_fault_under_the_timed_path_is_not_correct(name, fault, tmp_path, monkeypatch):
    cell = tiny_cell(name)
    faults.plant(cell, fault, monkeypatch.setattr)
    out = run(cell, tmp_path)
    assert not out["correct"], out["checks"]
    if fault.startswith("late_"):
        # the checked steps pass: the window's recorded step is what fails
        over = [c["name"] for c in out["checks"] if not c["value"] <= c["limit"]]
        assert over and all(n.startswith("window_") for n in over), out["checks"]


@pytest.mark.parametrize("kind", sorted(BEFORE))
def test_each_kind_keeps_its_faults_under_their_names(kind):
    assert faults.names(kind) == BEFORE[kind]
    assert faults.path(kind).is_file()


def test_a_kind_without_a_faults_file_has_none(tmp_path):
    assert faults.names("no_such_kind", root=tmp_path) == ()
    cell = type("Cell", (), {"traffic": {"kind": "no_such_kind"}})()
    with pytest.raises(FileNotFoundError, match="no_such_kind.py"):
        faults.plant(cell, "half_batch", None, root=tmp_path)

"""Readings from which a cell's limits are set, on the card, in one process.

    python3 gsbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed: one run of the cell with a window of ``--seconds`` (its
compared numbers: the program's readings, or with ``--fault`` a planted
fault's), then the same numbers with the reference in bfloat16 in the
program's place (the control's readings).  Prints one JSON line a seed.  The benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gsbench import faults, spec  # noqa: E402
from gsbench.run import execute  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", help="plant this fault of gsbench/faults/<kind>.py first")
    ap.add_argument("--control", type=int, choices=(0, 1), default=1,
                    help="also read the control (0: the program's numbers alone)")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    patches = faults.Patches()
    for seed in args.seeds:
        if args.fault:
            # planted anew for each seed: a late fault counts its calls from here
            faults.plant(cell, args.fault, patches)
        control: dict = {}
        with tempfile.TemporaryDirectory(prefix="gsbench-") as tmp:
            with contextlib.redirect_stdout(sys.stderr):
                out = execute(cell, seed, args.seconds, False, args.device, Path(tmp),
                              time.perf_counter(),
                              on_checked=(lambda loop: control.update(loop.control()))
                              if args.control else None)
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": out["correct"],
                          "program": {c["name"]: c["value"] for c in out["checks"]},
                          "control": control, "attempted": out["attempted"],
                          "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                          "memory_peak_bytes": out["memory_peak_bytes"]}), flush=True)
        patches.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings of `correct`'s numbers for the program and for its control, and
the control judged by the cell's limits.

    python3 -m slambench.control --workload <name> --seconds <s> --seeds <n> [<n> ...] [--out FILE]

Runs the cell once per seed in this process (set-up is long: one process
reads every seed), each time as `slambench.run` does, and prints one JSON
line per seed with the program's numbers and the control's on the same
frames: the reference's extraction with its pyramid in bfloat16 in the
front end's place, the program's poses and points rounded to bfloat16 in
the state's place (`slambench/check.py`). The control is judged by
`check.judge` against the cell's limits file, as a run is; the command
exits 4 when the control comes out correct on any seed. The limits in
`slambench/limits/` were set from these readings (`PERF.md`). The
benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from slambench import check, run


def reading(workload: str, seed: int, seconds: float, root: Path = run.ROOT,
            device: str = "cuda") -> dict:
    """One seed's line: the program's `correct` and numbers, the control's
    numbers, and the control judged by the cell's limits."""
    res = run.run_cell(workload, seed, seconds, False, device=device, root=root, control=True,
                       t_start=time.perf_counter())
    ok, checks = check.judge(res["control"], run.load_cell(root, workload)["limits"])
    return {"seed": seed, "correct": res["correct"], "failed": res["failed"],
            "program": res["readings"], "control": res["control"],
            "control_correct": bool(ok), "control_checks": checks, "metrics": res["metrics"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    lines = []
    for seed in a.seeds:
        line = reading(a.workload, seed, a.seconds)
        print(json.dumps(line), flush=True)
        for key, c in line["control_checks"].items():
            run.log(f"seed {seed} control {key}: {c['value']!r} (limit {c['limit']!r})")
        lines.append(line)
    if a.out:
        with open(a.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    bad = run.forbidden_modules()
    if bad:
        print("loaded:", bad, file=sys.stderr)
        return 3
    passed = [line["seed"] for line in lines if line["control_correct"]]
    if passed:
        run.log("the control came out correct on seeds", passed)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())

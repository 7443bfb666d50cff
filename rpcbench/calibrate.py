"""Reads a cell's checked numbers over many seeds in one process: the
program's (the lower readings its limits are set above) or the control's
(the upper readings they are set below).

    python3 rpcbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 3 --system program|control [--out FILE]

Each seed runs the cell's set-up, a short window at the cell's own sizes
and load, and its check, as a run does, and prints one JSON line with the
checks.  Every call's checksum is compared (`check_sum_every` 1), so a
short window compares as many as a run of the cell.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--system", choices=("program", "control"),
                    default="program")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    here = str(pathlib.Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p and
                   str(pathlib.Path(p).resolve()) != here]
    sys.path.insert(0, str(ROOT))
    from rpcbench import control, harness, spec

    s = spec.Spec.load(ROOT)
    mix = s.mix(s.cell(args.workload))
    system = (control.SYSTEMS[mix["generator"]]
              if args.system == "control" else None)
    rows = []
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        try:
            result = harness.run_cell(
                ROOT, args.workload, seed, args.seconds, False, t_start=t0,
                system=system,
                overrides={"check_sum_every": 1}, log=lambda line: None)
            row = {"seed": seed, "system": args.system,
                   "correct": result["correct"],
                   "attempted": result["attempted"],
                   "failed": result["failed"], "checks": result["checks"]}
        except Exception as e:  # noqa: BLE001 - a control may crash
            row = {"seed": seed, "system": args.system, "correct": False,
                   "error": f"{type(e).__name__}: {e}"}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())

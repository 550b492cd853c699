"""The readings that the check's limits are set from, over many seeds in
one process: the program's numbers (the lower readings), the control's
(the plain reference in the program's place in float32 with TF32
products) and a fault's (the reference in the program's place with the
fault planted, or the program with a fault of ``faults.py`` planted) for
the upper readings, and K2's frozen counts (the
reference's sweeps and Newton iterations a rod-step in float32 at the
cell's tolerance). Each run is set up, measured for ``--seconds`` and
checked as ``run.py`` does it; one JSON line per seed.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --kinds program,control,half_batch,carry_dropped,counts \
        [--seconds 2]
"""
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import faults  # noqa: E402
from portbench.harness import (feed_of, judge, require_chips,  # noqa: E402
                               setup_run)


def readings(workload: str, seed: int, kind: str, seconds: float,
             require=require_chips) -> dict:
    _, run, limits = setup_run(workload, seed, require)
    in_program = kind == "program" or kind in faults.PLANTED
    with (faults.planted(kind) if kind in faults.PLANTED
          else contextlib.nullcontext()):
        cell = feed_of(run.traffic).Cell(run)
        cell.warm()
        run.sync()
        w = cell.window(seconds)
    extra = None if in_program else cell.reference_in_place(kind)
    cell.release()
    t0 = time.perf_counter()
    rows, ok = judge(cell.check(), limits)
    return {"seed": seed, "kind": kind, "correct": ok,
            "numbers": {n: v for n, v, _, _ in rows}, "extra": extra,
            "e2e": cell.e2e(w), "check_s": time.perf_counter() - t0}


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="program",
                    help="comma-separated: program, control, half_batch, "
                    "counts, or a fault of faults.PLANTED")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    for kind in args.kinds.split(","):
        for s in args.seeds.split(","):
            print(json.dumps(readings(args.workload, int(s), kind,
                                      args.seconds)), flush=True)


if __name__ == "__main__":
    main()

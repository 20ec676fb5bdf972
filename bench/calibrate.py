"""Readings the limits of ``correct`` are set from; not part of a run.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 [--variants control,unchanged,half_batch,answer]

For each seed: the cell's set-up (the program driven through the checked
steps, no window), the reference, and each variant of the
reference put in the program's place: "control" (the cell's lower
precision) and the faults "unchanged", "half_batch", "answer".  Prints
one JSON line per seed with every number compared, for the program and
for each variant; a limit goes between the program's highest reading
and the least of the variants'.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="")
    args = ap.parse_args(argv)
    _environment()
    from bench import harness

    variants = [v for v in args.variants.split(",") if v]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = harness.load_cell(args.workload, seed, 0.0, False)
        harness.require_chips(cell.chips)
        got = harness.driver_of(cell).calibrate(cell, variants)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

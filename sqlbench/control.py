"""The readings that the limits of ``check.py`` were set from.

    python3 sqlbench/control.py --workload <name> --seconds <s> \
        --seeds 11,12,13

For each seed, in one process (the history store cleared between
seeds, as a fresh process starts it empty): one run of the cell with a
short window, its numbers compared (the program's lower reading), and
the control on the same statements: the plain reference computed in
float64 and in float32 put in the program's place, its rows held against
the exact reference (the upper reading). The configurations state exact
decimal arithmetic on 64-bit scaled integers; float64 is the nearest
precision below, float32 the next. Prints one JSON line per seed.
The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from sqlbench import check, run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    run.cache_dirs()
    from trino_tpu_torch.telemetry import stats_store

    ok = True
    for seed in (int(s) for s in args.seeds.split(",")):
        stats_store.store().clear()
        run.T_START = time.time()
        line, numbers, records, db = run.run_cell(
            args.workload, seed, args.seconds, False)
        out = {"seed": seed, "correct": line["correct"],
               "program": numbers,
               "metrics": {k: v["value"] for k, v in line["metrics"].items()}}
        for acc in ("float64", "float32"):
            out[f"control_{acc}"] = check.control(records, db, acc)
        ok &= line["correct"]
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Runs one cell several times and reports each metric's spread.

    python3 sqlbench/spread.py --workload <name> --seconds <s> \
        --seeds 11,12,13 [--trace 0|1] [--out runs.jsonl]

Each run is ``sqlbench/run.py`` in a process of its own, one after the
other, with the seeds given in order. Prints every run's result line
and, per metric, the values, the median and the spread (the distance
between the first and the third quartile as a share of the median,
``statistics.quantiles``, n=4), and whether every run was correct.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from sqlbench import summary  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True)
        out = proc.stdout.strip().splitlines()
        line = json.loads(out[-1]) if proc.returncode == 0 and out else None
        print(json.dumps({"seed": seed, "rc": proc.returncode,
                          "line": line}), flush=True)
        if line is None:
            print(proc.stderr[-3000:], file=sys.stderr)
        else:
            print("\n".join(x for x in proc.stderr.splitlines()
                            if x.startswith("sqlbench:")), file=sys.stderr)
        lines.append((seed, line))
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps({"workload": args.workload, "seed": seed,
                                    "rc": proc.returncode,
                                    "line": line}) + "\n")
    ok = [line for _, line in lines if line is not None]
    names = sorted({m for line in ok for m in line["metrics"]})
    for m in names:
        vals = [line["metrics"][m]["value"] for line in ok
                if m in line["metrics"]]
        sp = summary.spread(vals) if len(vals) >= 2 else float("nan")
        print(f"{m}: median {statistics.median(vals):.6g} spread "
              f"{sp:.4f} values {[round(v, 4) for v in vals]}")
    print(f"correct: {[line['correct'] for line in ok]}; "
          f"runs without a result: {len(lines) - len(ok)}")
    return 0 if len(ok) == len(lines) and all(
        line["correct"] for line in ok) else 1


if __name__ == "__main__":
    sys.exit(main())

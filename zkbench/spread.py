"""Run one cell on a list of seeds, in sets, and print each metric's spread.

  python3 zkbench/spread.py --workload <cell> --seeds 1,2,3,4,5,6 --sets 2 \
      --seconds 51 [--trace 0] [--out FILE]

Each run is a process of its own, `zkbench/run.py` as BENCHMARK.json's
command starts it; the sets use the same seeds in the same order.  Every
result line (with the seed, the set, the exit code and the wall seconds) is
appended to --out; at the end, for every metric, each set's median and its
spread: the distance between the first and third quartiles
(statistics.quantiles, n=4) as a share of the median; then the mean of
the sets' spreads, each without its run farthest from its median, and the
spread of all runs together.  The first run of a checkout builds and
derives, so its set-up is shown apart.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[0] = os.path.dirname(HERE)
    from zkbench.stats import spread, without_farthest

    seeds = args.seeds.split(",")
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, os.path.join(HERE, "run.py"), "--workload", args.workload,
                 "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
                cwd=os.path.dirname(HERE), capture_output=True, text=True)
            lines = proc.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if proc.returncode == 0 else None
            except (IndexError, json.JSONDecodeError):
                res = None
            row = {"workload": args.workload, "set": k, "seed": int(seed), "rc": proc.returncode,
                   "wall_s": time.time() - t0, "result": res,
                   "card": next((ln for ln in lines if ln.startswith("card:")), None)}
            if res is None:
                row["stderr"] = proc.stderr[-3000:]
            runs.append(row)
            print(json.dumps(row), flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    ok = [r for r in runs if r["result"]]
    names = sorted({m for r in ok for m in r["result"]["metrics"]})
    for name in names:
        sets = []
        for k in range(args.sets):
            vals = [r["result"]["metrics"][name]["value"] for r in ok
                    if r["set"] == k and name in r["result"]["metrics"]]
            if name == "setup_s" and k == 0 and vals:
                print(f"{name} set {k}: first run {vals[0]:.4f}; the others below")
                vals = vals[1:]
            if vals:
                sets.append(vals)
                print(f"{name} set {k}: n {len(vals)} median {statistics.median(vals):.6g} "
                      f"spread {spread(vals)}")
        trimmed = [spread(without_farthest(v)) for v in sets if len(v) > 2]
        if trimmed and None not in trimmed:
            print(f"{name}: mean spread of the sets without each one's run farthest from "
                  f"its median {statistics.mean(trimmed):.6g}; spread of all runs "
                  f"{spread([x for v in sets for x in v])}")
    print(f"correct {sum(r['result']['correct'] for r in ok)} of {len(runs)} runs")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings for the limits of `correct`: the program's, the controls' and
the faults' numbers, many seeds of one cell in one process.

  python3 zkbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5 \
      [--plants none,rs_reused,masks_reused,stale_proof,...] [--out FILE]

For each plant ("none" is the program as it is) and each seed, one run of
the cell as run.py makes it (set-up, a window of --seconds, the check),
with the fault of zkbench/faults.py planted under it.  Prints, and appends
to --out, one JSON line a run: the plant, the seed, `correct`, the proofs
and each number compared.  The benchmark's own runs never plant anything.
"""

import contextlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--plants", default="none")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from zkbench import faults, harness

    harness._cache_env()
    import torch

    if not torch.cuda.is_available():
        print("zkbench control: no CUDA device", file=sys.stderr)
        return 2
    for plant in args.plants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.time()
            ctx = faults.planted(plant) if plant != "none" else contextlib.nullcontext()
            with ctx:
                res = harness.run_cell(args.workload, seed, args.seconds, False, "cuda")
            line = {"workload": args.workload, "plant": plant, "seed": seed,
                    "correct": res["correct"], "attempted": res["attempted"],
                    "checks": {k: v["value"] for k, v in res["checks"].items()},
                    "proof_s": res["metrics"].get("proof_s", {}).get("value"),
                    "run_s": time.time() - t0}
            print(json.dumps(line), flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())

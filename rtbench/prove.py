"""The readings the check's limits are set from: runs of one cell on many
seeds in one process, each printing one JSON line of its compared numbers.

    python3 rtbench/prove.py --workload <cell> --seconds 3 \
        --seeds 11 12 13 [--check-mode control] [--fault half_batch]

A run's set-up, window and check are ``run.py``'s; only the process is
shared, so its import and the card's start are paid once. Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run as entry  # sets the cache directories and the import path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--check-mode", choices=("program", "control"), default="program")
    ap.add_argument("--fault", default="none")
    args = ap.parse_args(argv)
    import torch

    from rtb import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        t0 = time.time()
        out = harness.run(cell, seed, args.seconds, False, check_mode=args.check_mode,
                          fault=args.fault, started=t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": args.check_mode, "fault": args.fault,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "metrics": out["metrics"],
                          "checks": {k: v["value"] for k, v in out["checks"].items()},
                          "wall_s": time.time() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, limits
and metrics are found by name (``rtb/spec.py``). With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics. The last lines of standard error give each compared
number beside its limit; the last line of standard output is the result.
The run needs a CUDA card: without one, or with fewer cards than the cell
asks for, it exits with code 2 and prints no result.

``--check-mode control`` and ``--fault`` are for proving the check's
limits (PERF.md): the first judges the reference computed in bfloat16 in the
program's place, the second breaks the timed path (``unchanged``: a train
step leaves the parameters as they were; ``half_batch``: a train step takes
half of its rays; ``alter``: every frame's red channel is raised by 2**-6).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "rtbench")

# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [HERE, ROOT]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--check-mode", choices=("program", "control"), default="program")
    ap.add_argument("--fault", choices=("none", "unchanged", "half_batch", "alter"),
                    default="none")
    return ap.parse_args(argv)


def print_checks(out):
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)


def main(argv=None):
    args = parse(argv)
    import time

    t_entry = time.time()
    import torch

    from rtb import harness, spec

    t_torch = time.time()

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.zeros(1, device="cuda:0")
    started = harness.process_start_time()
    print(f"set-up: to the entry point {t_entry - started:.2f} s, torch's import "
          f"{t_torch - t_entry:.2f} s, the card's start {time.time() - t_torch:.2f} s",
          file=sys.stderr)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      check_mode=args.check_mode, fault=args.fault)
    print_checks(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

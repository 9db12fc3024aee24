#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 slam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the repository's root, on a machine with an NVIDIA card; without one
(or with fewer cards than the cell asks for) it exits with 2 and prints no
result.  The last line of standard output is one JSON object (correct,
attempted, failed, metrics, device, with --trace 1 breakdown, and last the
numbers compared with their limits, which also end standard error).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the repository's root instead of this folder: the harness's modules are
# imported as slam_bench.*, and none of them may shadow a standard module
sys.path[0] = str(ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from slam_bench.harness import forbidden_modules, load_cell, run_cell

    cell = load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slam_bench: {args.workload} needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    win = res.pop("_window")
    res.pop("_diag")
    # what the process holds once the window and the comparison are done
    found = forbidden_modules()
    if found:
        print(f"slam_bench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"window {win['seconds']:.3f} s, {win['steps']} steps in it, "
          f"{win['steps_total']} in all, set-up {win['setup_s']:.3f} s",
          file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

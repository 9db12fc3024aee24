#!/usr/bin/env python3
"""Readings of the comparison that decides `correct`, for setting a cell's
limits (not run by the benchmark's own runs).

    python3 slam_bench/readings.py --workload <name> --seeds 1,2,3 \\
        [--control none|tf32|bf16|frozen|half|alter] [--seconds S]

Runs the cell once a seed in one process, as run.py does (set-up, a window
of S seconds, the comparison), and prints one JSON line a seed with every
number compared.  `--control` puts a lower precision in the program's
place or plants a fault under the timed path (slam_bench/faults.py).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from slam_bench.faults import HOOKS  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", choices=sorted(HOOKS), default="none")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args()

    import torch

    from slam_bench.harness import load_cell, run_cell

    if not torch.cuda.is_available():
        print("slam_bench: readings need a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    bench = json.loads((Path(__file__).resolve().parent.parent
                        / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = run_cell(cell, seed, seconds, False, t, hooks=HOOKS[args.control])
        win = res["_window"]
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": args.control,
            "correct": res["correct"],
            "checks": {n: c["value"] for n, c in res["checks"].items()},
            "diag": res["_diag"],
            "scans_per_s": res["metrics"]["scans_per_s"]["value"],
            "steps": win["steps_total"], "setup_s": win["setup_s"],
            "run_s": time.perf_counter() - t,
            "memory_peak_bytes": res["device"]["memory_peak_bytes"]}), flush=True)
        # the next seed starts from the programme's defaults
        from lego_loam_tpu_torch.utils.precision import apply_f32_policy
        apply_f32_policy()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set the limits of `correct` (PERF.md gives them):

    python3 odom_bench/tools/control.py --workload <cell> --seeds 11 12 13 --steps 120

For each seed, at the cell's own size on the card, the numbers `check`
compares when the program's place is taken by (1) the control, the
reference computed in float32 where the configuration states float64, and
by the timed path broken in three ways: (2) a step that returns its state
unchanged, (3) half the batch left out, (4) every stream's pose moved by
10 cm where the step produces it. Each run has `--steps` steps after the
warm-up. Prints one JSON line a run."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from odom_bench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    kinds = {
        "control_f32": faults.control,
        "state_unchanged": lambda: faults.state_unchanged,
        "half_batch": lambda: faults.half_batch,
        "altered_pose": lambda: faults.altered_pose(args.steps // 6 * 3 + 2),
    }
    for seed in args.seeds:
        for kind, make in kinds.items():
            if args.only and kind not in args.only:
                continue
            res = harness.run_cell(ROOT, args.workload, seed, 0.0, False, device="cuda:0",
                                   steps=args.steps, wrap_step=make())
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "correct": res["correct"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

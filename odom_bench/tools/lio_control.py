"""Readings that set the limits of `correct` for the LiDAR-inertial
ensemble (`drivers/lio_ensemble.py`; PERF.md gives them):

    python3 odom_bench/tools/lio_control.py --workload <cell> --seeds 11 12 13 --steps 60

For each seed, at the cell's own size on the card, the numbers `check`
and the driver compare when the program's place is taken by (1) the
control, the reference with its filter in float32 where the configuration
states float64, and by the timed path broken in four ways: (2) one IMU
sample of every stream's packet dropped at one step, (3) the IMU deskew
replaced by the constant-velocity deskew, (4) one compared stream's filter
position moved by 10 cm after one step, (5) half the batch left out. Each
run has `--steps` steps after the warm-up; `--sound` adds a run of the
program as it is. Prints one JSON line a run."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from odom_bench import harness, lio_faults  # noqa: E402


def kinds(steps: int, warmup: int) -> dict:
    """Each kind's `wrap_step` factory; the one-step faults strike in the
    middle of the window."""
    mid = warmup + steps // 2
    return {
        "control_f32": lio_faults.control,
        "imu_sample_dropped": lambda: lio_faults.imu_sample_dropped(mid),
        "cv_deskew": lambda: lio_faults.cv_deskew,
        "filter_moved": lambda: lio_faults.filter_moved(mid),
        "half_batch": lambda: lio_faults.half_batch,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--sound", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    from odom_bench.common import manifest

    warmup = int(manifest.resolve(ROOT, args.workload).mix["warmup_steps"])
    table = kinds(args.steps, warmup)
    if args.sound:
        table = {"sound": lambda: None, **table}
    for seed in args.seeds:
        for kind, make in table.items():
            if args.only and kind not in args.only:
                continue
            res = harness.run_cell(ROOT, args.workload, seed, 0.0, False, device=args.device,
                                   steps=args.steps, wrap_step=make())
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "correct": res["correct"], "failed": res["failed"],
                              "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

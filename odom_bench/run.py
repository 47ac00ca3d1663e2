"""Run one cell of BENCHMARK.json on the card:

    python3 odom_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints progress and, last, each compared number beside its limit on
standard error, and the result as one JSON line, last on standard output.
Exits non-zero, printing no result, without a CUDA card (there is no CPU
fallback), or when JAX or the JAX package was loaded."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from odom_bench import harness  # noqa: E402


def _power_limit() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30)
        return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from odom_bench.common import manifest

    cell = manifest.resolve(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"odom_bench: {cell.chips} CUDA card(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = _power_limit()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda:0")
    result["device"]["card"] = card
    found = harness.forbidden_modules()
    if found:
        print(f"odom_bench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

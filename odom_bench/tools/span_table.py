"""Per-span times of one traced run of a cell (PERF.md's table of spans):

    python3 odom_bench/tools/span_table.py --workload <cell> --seed <n> [--out <file.json>]

Runs the cell as `run.py --trace 1` does and prints, for each range of its
profiled window (the port's spans and the harness's step ranges): openings
a step, device ms a step launched inside it (nested ranges included, and
alone), and host ms a step of its openings less their nested ranges. Host
times are taken under the profiler, which records every aten op, and are
inflated by it. Then the buckets of the four span metrics, `icp.gn`, the
harness's gather and what no program span holds, against the window's
summed device time; where K5 was launched; the result line's metrics."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from odom_bench import harness  # noqa: E402
from odom_bench.common import manifest, spans  # noqa: E402

METRICS = ("preprocess_device_ms", "map_device_ms", "icp_fetch_device_ms",
           "register_self_device_ms")
HARNESS = ("odom_bench.gather", "odom_bench.preprocess", "odom_bench.perturb",
           "odom_bench.register")
K5 = "gn_cluster_kernel"


def buckets(sp: spans.Spans, steps: int) -> dict:
    """Device ms a step of each bucket that should partition the window."""
    out = {}
    for name in METRICS:
        reader = harness._load_metric(name, manifest.BENCH_DIR)
        field = "self" if name == "register_self_device_ms" else "total"
        out[name] = sum(getattr(sp, field).get(n, 0.0) for n in reader.SPANS)
    out["icp.gn"] = sp.total.get("icp.gn", 0.0)
    out["odom_bench.gather"] = sp.total.get("odom_bench.gather", 0.0)
    for r in HARNESS[1:] + (spans.NO_SPAN, spans.NO_LAUNCH):
        out[f"no program span: {r}"] = sp.self.get(r, 0.0)
    return {k: v * 1e3 / steps for k, v in out.items()}


def table(sp: spans.Spans, steps: int) -> dict:
    rows = {}
    for name in sorted(set(sp.opened) | set(sp.total) | set(sp.self)):
        top = sorted(((op, v) for (inner, op), v in sp.ops.items() if inner == name),
                     key=lambda kv: -kv[1][0])[:4]
        rows[name] = {
            "opened_per_step": sp.opened.get(name, 0) / steps,
            "device_ms": sp.total.get(name, 0.0) * 1e3 / steps,
            "device_self_ms": sp.self.get(name, 0.0) * 1e3 / steps,
            "host_self_ms": sp.host_self.get(name, 0.0) * 1e3 / steps,
            "parents": sorted(str(p) for p in sp.parents.get(name, ())),
            "top_ops": [[op[:90], v[0] * 1e3 / steps, v[1] / steps] for op, v in top],
        }
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    kept = []
    of = spans.of

    def keep(ctx):
        sp = of(ctx)
        if sp is not None and not kept:
            kept.append((sp, ctx.profiled_steps))
        return sp

    spans.of = keep
    try:
        res = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, True,
                               device=args.device)
    finally:
        spans.of = of
    if not kept:
        print("span_table: the run left no spans (no trace)", file=sys.stderr)
        return 1
    sp, steps = kept[0]
    b = buckets(sp, steps)
    device_ms = sp.device_s * 1e3 / steps
    k5 = {}
    for (inner, op), (secs, count) in sp.ops.items():
        if K5 in op:
            k5[inner] = k5.get(inner, 0) + count
    out = {"workload": args.workload, "seed": args.seed, "steps": steps,
           "device_ms": device_ms, "buckets": b,
           "buckets_sum_share": sum(b.values()) / device_ms if device_ms else None,
           "k5_launches_by_span": k5, "spans": table(sp, steps),
           "window_s": res["device"].get("window_s"), "busy_s": res["device"].get("busy_s"),
           "correct": res["correct"], "metrics": res["metrics"]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "spans"}))
    for name, row in out["spans"].items():
        print(f"{name:24s} {row['opened_per_step']:6.2f}/step device {row['device_ms']:9.3f} "
              f"self {row['device_self_ms']:9.3f} host self {row['host_self_ms']:9.3f} ms/step "
              f"in {row['parents']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

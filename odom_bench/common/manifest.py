"""BENCHMARK.json and the files it names: a cell `<config>.<traffic>`
resolves to the configuration's file (`configs[].file`), the mix's file
(`odom_bench/mixes/<traffic>.json`) and the metrics it reports, each read
by `odom_bench/metrics/<metric>.py`. Nothing here is per cell."""

from __future__ import annotations

import json
import os
import re
from typing import NamedTuple

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = "mixes"
METRICS = "metrics"
DRIVERS = "drivers"


class Cell(NamedTuple):
    name: str
    config: dict  # the configuration file's object
    mix: dict  # the mix file's object
    chips: int
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def load_manifest(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric` (no `workloads` key: every cell)."""
    return cell in metric.get("workloads", [cell])


def resolve(root: str, workload: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell named `workload` of root/BENCHMARK.json, with its files
    read. The mix is looked up under bench_dir/mixes by its traffic name."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    mix = _load_json(os.path.join(bench_dir, MIXES, f"{w['traffic']}.json"))
    return Cell(
        name=workload, config=config, mix=mix, chips=int(w["chips"]),
        end_to_end=[m for m in man["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in man["per_layer"] if reports(m, workload)],
    )


def metric_file(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, METRICS, f"{name}.py")


def driver_file(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, DRIVERS, f"{name}.py")

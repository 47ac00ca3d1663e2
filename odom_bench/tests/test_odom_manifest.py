"""BENCHMARK.json against the contract's rules that a CPU run can check:
every cell resolves to its files by name, names and units use only the
allowed characters, every metric has its reader, each per-layer metric's
`workloads` are cells that report the end-to-end metric it moves, and a
cell made of new files in a temporary directory runs."""

import json
import os

import pytest

from odom_bench import harness
from odom_bench.common import manifest, pipeline
from odom_bench.tests import cells

ROOT = os.path.dirname(manifest.BENCH_DIR)
MAN = manifest.load_manifest(ROOT)


def test_top_level_keys_and_paths():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["odom_bench"]
    assert all(not w.startswith("/") and ".." not in w for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves(cell):
    c = manifest.resolve(ROOT, cell)
    assert c.chips == 1
    pipeline.port_config(c.config)  # the file's pipeline is what runs
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert set(c.config["reduced"]) == set(
        next(x for x in MAN["configs"] if x["name"] == cell.split(".")[0])["reduced"])


def test_names_units_and_readers():
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    every = [m["name"] for m in metrics] + [w["name"] for w in MAN["workloads"]] + \
        [c["name"] for c in MAN["configs"]] + [w["traffic"] for w in MAN["workloads"]] + \
        [k for c in MAN["configs"] for k in c["reduced"]]
    assert all(manifest.NAME.match(n) for n in every), every
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert manifest.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.isfile(manifest.metric_file(m["name"]))
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for entry in MAN["configs"] + MAN["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]


def test_per_layer_workloads_report_what_they_move():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells_ = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= cells_
        assert all(manifest.reports(e2e[m["moves"]], w) for w in m["workloads"])
    for w in cells_:
        assert any(manifest.reports(m, w) for m in MAN["per_layer"])


def test_new_cell_from_new_files(tmp_path):
    name = cells.build(str(tmp_path), "livox_dense", streams=2, compare=1)
    with open(tmp_path / "BENCHMARK.json") as f:
        assert json.load(f)["workloads"][0]["name"] == name
    res = harness.run_cell(str(tmp_path), name, 12345, 0.0, True, device="cpu",
                           bench_dir=str(tmp_path), log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                        "checks"}
    assert list(res)[-1] == "checks"
    assert "ops_per_step" in res["metrics"] and "host_enqueue_ms" in res["metrics"]

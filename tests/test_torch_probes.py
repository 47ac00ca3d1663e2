"""The port's probe kernels P1-P4 (`ops/kernels/probes.py`) against the JAX
package's Pallas probes in `tools/`, run in interpret mode on the CPU.

The tools are loaded from their files (`tools/` is not a package) and
their `timeit` is replaced by one that records each call's inputs and
output, so the port's plain versions see exactly the JAX kernels' inputs.

Tolerances: the gathers (`take_rows` over P1 / P4, `take_lanes` over P2)
bit-equal, f32 and i32. `gn_proto` over P3 (at NQ = 1024, NC = 16, QR = 8,
8 iterations): the 13 outputs within 1e-6 (R, and t in m) and `conv`
equal; the two differ only by the f32 summation order of XLA's and
torch's reductions (measured 3e-8). The probe entry point runs every probe
with `--device cpu` and reports each correct.
"""

import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

from lidar_imu_slam_tpu_torch.ops.kernels import icp_gn
from lidar_imu_slam_tpu_torch.ops.kernels import probes as kp
from lidar_imu_slam_tpu_torch.tools import probes as tp

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
GN_TOL = 1e-6


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_probe_{name}",
                                                  os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(monkeypatch, mod):
    calls = []

    def timeit(f, *args, n=50):
        out = f(*args)
        calls.append(([np.asarray(a) for a in args], np.asarray(out)))
        return 0.0, out

    monkeypatch.setattr(mod, "timeit", timeit)
    return calls


@pytest.fixture(scope="module")
def jax_gather():
    mp = pytest.MonkeyPatch()
    try:
        mod = _load("exp_pallas")
        calls = _recording(mp, mod)
        mod.probe_gather(interpret=True)
    finally:
        mp.undo()
    return calls  # run_take, run_lane, the XLA baseline


@pytest.fixture(scope="module")
def jax_gather2():
    mp = pytest.MonkeyPatch()
    try:
        mod = _load("exp_gather2")
        calls = _recording(mp, mod)
        mp.setattr(sys, "argv", ["exp_gather2.py", "--interpret"])
        mod.main()
    finally:
        mp.undo()
    return calls  # taa (C,128), taa (C,512), i32 broadcast, three XLA baselines


@pytest.fixture(scope="module")
def jax_gn():
    mp = pytest.MonkeyPatch()
    try:
        mod = _load("exp_pallas")
        calls = _recording(mp, mod)
        for k, v in (("NQ", 1024), ("NC", 16), ("QR", 8)):
            mp.setattr(mod, k, v)
        mod.probe_gn(interpret=True)
    finally:
        mp.undo()
    return calls[0]


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy of the recorded array


def _bit_equal(a: torch.Tensor, b: np.ndarray):
    a = a.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_p1_row_gather_bit_equal(jax_gather):
    (table, idx), out = jax_gather[0]  # run_take hands the kernel idx[:, None]
    assert idx.shape == (2048,) and table.dtype == np.float32
    _bit_equal(kp.take_rows(_t(table), _t(idx[:, None])), out)


def test_p2_lane_gather_bit_equal(jax_gather):
    (table, idx), out = jax_gather[1]
    assert table.shape == (8, 8192) and idx.shape == (8, 2048)
    _bit_equal(kp.take_lanes(_t(table), _t(idx)), out)


@pytest.mark.parametrize("case,width,dtype", [(0, 128, np.float32), (1, 512, np.float32),
                                              (2, 128, np.int32)])
def test_p4_take_along_axis_bit_equal(jax_gather2, case, width, dtype):
    (table, idx), out = jax_gather2[case]
    assert table.shape == (8192, width) and table.dtype == dtype
    assert idx.shape == ((2048, 1) if case == 2 else (2048, width))
    _bit_equal(kp.take_rows(_t(table), _t(idx)), out)


def test_library_baselines_compute_the_same_gathers(jax_gather, jax_gather2):
    # the entry point's yardsticks (index_select) equal the XLA baselines' t[i]
    for (table, idx), out in (jax_gather[2], *jax_gather2[3:]):
        got = torch.index_select(_t(table), 0, _t(idx).long()).numpy()
        np.testing.assert_array_equal(got, out)


@pytest.mark.parametrize("case", [0, 1])
def test_p4_yardstick_is_the_same_function(jax_gather2, case):
    # the entry point's yardstick for the (N, W)-index cases, torch.gather on
    # axis 0, is take_along_axis itself: equal to the Pallas kernel's output,
    # and to the port's kernel on an index whose columns differ
    (table, idx), out = jax_gather2[case]
    got = torch.gather(_t(table), 0, _t(idx).long()).numpy()
    np.testing.assert_array_equal(got, out)
    rng = np.random.default_rng(case)
    mixed = rng.integers(0, table.shape[0], idx.shape).astype(np.int32)
    np.testing.assert_array_equal(kp.take_rows(_t(table), _t(mixed)).numpy(),
                                  torch.gather(_t(table), 0, _t(mixed).long()).numpy())


def test_p3_gn_proto_matches_jax(jax_gn):
    (kth, maxd2, qx, qy, qz, qm, cx, cy, cz), out = jax_gn
    nc = cx.shape[0]
    q = _t(np.stack([qx.reshape(-1), qy.reshape(-1), qz.reshape(-1)]))
    cand = _t(np.stack([c.reshape(nc, -1) for c in (cx, cy, cz)]))
    scal = torch.tensor([kth[0], maxd2[0]], dtype=torch.float32)
    got = kp.gn_proto(q, _t(qm.reshape(-1)), cand, scal, 8).numpy()
    want = out[0, :13]
    assert got.dtype == np.float32 and got.shape == (13,)
    np.testing.assert_allclose(got[:12], want[:12], rtol=0, atol=GN_TOL)
    assert got[12] == want[12]
    assert abs(got[9]) > 0.05  # the solve moved: the probe's shift is partly undone


def test_gn_proto_conv_freezes_the_pose():
    # with a query budget below the 20-correspondence floor, the first
    # iteration sets conv and every later one leaves the identity in place
    x = tp.gn_inputs("cpu", nq=16, nc=4)
    out = kp.gn_proto(x["q"], x["qmask"], x["cand"], x["scal"], 3)
    np.testing.assert_array_equal(out.numpy(), [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1])


def test_probe_entry_point_on_cpu():
    buf = io.StringIO()
    rows = tp.run("all", "cpu", out=buf)
    lines = buf.getvalue().splitlines()
    assert len(lines) == len(rows) == 8
    assert all(r["correct"] for r in rows), lines
    kernels = {r["kernel"] for r in rows}
    assert kernels == {"take_rows", "take_lanes", "gn_proto", None}
    assert {r["probe"] for r in rows} == {"P1", "P2", "P3", "P4"}
    for r in rows:
        if r["kernel"] is None:
            continue
        # each kernel case carries what a bound and a comparison need; on
        # the CPU the wrapper is its plain version, and the device and host
        # times are not measured
        assert r["max_abs_err"] == 0.0 and r["plain_ms"] == r["ms"] and r["bytes"] > 0
        assert (r["library_ms"] is None) == (r["kernel"] == "gn_proto")
        assert (r["ops"] > 0) == (r["kernel"] == "gn_proto")
        assert r["device_ms"] is r["host_ms"] is r["library_device_ms"] is None
    # P4's (N, W)-index cases: torch.gather, with index_select as history
    taa = [r for r in rows if r["name"].startswith("taa axis=0 (C,")]
    assert len(taa) == 2
    assert all(r["library"] == "torch.gather" and r["history"][0] == "torch.index_select"
               for r in taa)
    # P1: the index, the 2048 indices' distinct rows and the output
    p1 = rows[0]
    hit = len(np.unique(tp.gather_inputs("cpu")["idx"].numpy()))
    assert p1["bytes"] == 2048 * 4 + hit * 128 * 4 + 2048 * 128 * 4
    assert tp.main(["gather", "--device", "cpu"]) == 0


@pytest.mark.parametrize("nq,nc,clusters", [(4096, 80, 16), (2048, 80, 8), (1000, 16, 1),
                                            (4096, 16, 4), (100_000, 80, 16)])
def test_gn_proto_cluster_rule(nq, nc, clusters):
    # gn_proto's cluster is K1's: min(16, ceil(N * NC / (256 * 80))) CTAs,
    # each a whole number of warps of queries, together covering N
    c, per = icp_gn.launch_shape(nq, nc)
    assert c == clusters and per % 32 == 0 and c * per >= nq > (c - 1) * per
    src = open(os.path.join(os.path.dirname(kp.__file__), "..", "..", "csrc", "probes.cu")).read()
    assert f"constexpr int kGnMaxCluster = {icp_gn.MAX_CLUSTER};" in src
    assert "constexpr int kGnThreads = 256;" in src  # the rule's 256 queries a CTA

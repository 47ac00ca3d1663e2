"""The measurement probes P1-P4 on the port's kernels: the counterpart of the
JAX package's `tools/exp_pallas.py` and `tools/exp_gather2.py`.

    python -m lidar_imu_slam_tpu_torch.tools.probes {gather,gn,gather2,all} \
        [--device cuda|cpu]

* gather  (exp_pallas.py:probe_gather): P1, the row gather of a (8192, 128)
  f32 table by 2048 indices (`take_rows` with an (N, 1) index), beside
  the PyTorch library call (`torch.index_select`) where the JAX tool times
  XLA's; P2, the lane gather of a (8, 8192) table by (8, 2048) indices
  (`take_lanes`), beside `torch.gather`.
* gn      (exp_pallas.py:probe_gn): P3, 8 f32 GN iterations over 4096
  queries x 80 candidates (`gn_proto`). Correct when the translation
  points back along the probe's (+0.3, -0.2, +0.1) m query shift (8
  iterations undo part of it) and, on the card, the kernel is within
  GN_TOL of its plain version with an equal `conv`. No library call
  computes it.
* gather2 (exp_gather2.py:main): P4, take_along_axis on axis 0 at W = 128
  and 512 (`take_rows`, (N, W) index) beside `torch.gather` on axis 0 (the
  same function; `torch.index_select` of the flat index, a narrower one,
  is printed beside it as history), and the i32 table by an (N, 1) index
  beside `torch.index_select`; then the library row gathers the JAX tool
  times alone: 32k rows of (8192, 30) f32 and of (8192, 15) i64.

One line per probe: its name; for the kernel and for its library call
three times per call; the plain version's time; the kernel's largest
deviation from its plain version and `correct=...` (the gathers must equal
numpy's gather and, on the card, their plain versions bit for bit). The
three times on the card, after a warm-up call:

* `ms`: CUDA events around REPS back-to-back calls. When the host takes
  longer to enqueue a call than the card to run it, this is the host's rate;
* `device`: the same REPS calls queued behind a stream sleep
  (`torch.cuda._sleep`), so the events time the kernels back to back: the
  card's time per call, free of the host's;
* `host`: the host clock over HOST_REPS calls with no synchronize inside
  the loop: the host's time to enqueue one call.

Each is the median of ROUNDS rounds that take the kernel and its library
call in turns (the host's speed drifts by tens of percent within a run).

With `--device cpu` the wrappers run their plain versions, each timed once
by the host clock; device and host times are not measured there. Inputs
come from `numpy.random.default_rng(0)`, drawn in the JAX tools' order
(exp_gather2's and the GN probe's arrays are the JAX tools' own).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops.kernels import probes as kp

C, N = 8192, 2048  # table rows, queries (both tools)
W = 128  # exp_pallas' table lanes
NQ, NC, N_INNER = 4096, 80, 8  # exp_pallas' GN prototype
SHIFT = (0.3, -0.2, 0.1)  # the GN probe's query offset
# gn_proto against its plain version on the card: R and t (m) differ only
# by the order of the f32 block sums
GN_TOL = 1e-5
REPS = 100  # timed calls per measurement on the card
HOST_REPS = 1000  # calls the host clock times for the enqueue time
ROUNDS = 5  # rounds of each measurement on the card, the reported time their median
# the stream's sleep ahead of a device-time measurement: 100M cycles, 50 ms
# at the H100's 1.98 GHz boost clock (longer at lower clocks)
SLEEP_CYCLES = 100_000_000
SLEEP_MS = 50.0


def _ms(fn, device: torch.device) -> float:
    """ms per call: CUDA events over REPS calls on the card, the host clock
    over one call on the CPU; both after a warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / REPS
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def device_ms(fn, reps: int = REPS) -> float:
    """The card's time per call: the stream sleeps while the host queues
    `reps` calls, so the events time the calls back to back, free of the
    host's launch cost. Raises when queueing outlasted half the sleep."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    end.record()
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued * 1e3 >= 0.5 * SLEEP_MS:
        raise RuntimeError(f"device timing: queueing took {queued * 1e3:.1f} ms")
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = HOST_REPS) -> float:
    """The host's time to enqueue one call: the host clock over `reps`
    calls, no synchronize inside the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def _times(fn, device: torch.device) -> dict:
    """ms, device_ms and host_ms of one call (the last two None off the
    card)."""
    on_card = device.type == "cuda"
    return dict(ms=_ms(fn, device), device_ms=device_ms(fn) if on_card else None,
                host_ms=host_ms(fn) if on_card else None)


def _times_in_turns(fns, device: torch.device) -> list[dict]:
    """`_times` of each function; on the card the median of ROUNDS rounds
    that take the functions in turns, forwards then backwards, so a drift
    of the host's speed falls on all of them alike."""
    runs = [[] for _ in fns]
    for r in range(ROUNDS if device.type == "cuda" else 1):
        order = range(len(fns)) if r % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            runs[i].append(_times(fns[i], device))
    return [{k: None if t[0][k] is None else float(np.median([x[k] for x in t])) for k in t[0]}
            for t in runs]


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def gather_inputs(device) -> dict:
    """P1 / P2 inputs (exp_pallas.py:40-72)."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, C, size=(N,)).astype(np.int32)
    idx2 = rng.integers(0, C, size=(8, N)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return dict(
        table=t(np.arange(C * W, dtype=np.float32).reshape(C, W)),
        idx=t(idx[:, None]),
        table2=t(np.arange(8 * C, dtype=np.float32).reshape(8, C)),
        idx2=t(idx2),
    )


def gather2_inputs(device) -> dict:
    """P4 inputs (exp_gather2.py:51-107), drawn in the JAX tool's order."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(C, 128)).astype(np.float32)
    idx1 = rng.integers(0, C, size=(N,)).astype(np.int32)
    table2 = rng.normal(size=(C, 512)).astype(np.float32)
    ktab = rng.integers(0, 1 << 30, size=(C, 128)).astype(np.int32)
    tab30 = rng.normal(size=(C, 30)).astype(np.float32)
    big_idx = rng.integers(0, C, size=(32768,)).astype(np.int32)
    tab15 = rng.integers(0, 1 << 60, size=(C, 15)).astype(np.int64)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return dict(
        table=t(table), idx1=t(idx1[:, None]),
        idx=t(np.broadcast_to(idx1[:, None], (N, 128))),
        table2=t(table2), idxw=t(np.broadcast_to(idx1[:, None], (N, 512))),
        ktab=t(ktab), tab30=t(tab30), big_idx=t(big_idx), tab15=t(tab15),
    )


def gn_inputs(device, nq: int = NQ, nc: int = NC) -> dict:
    """P3 inputs (exp_pallas.py:278-290) in the port's layouts: q (3, NQ),
    qmask (NQ,) bool, cand (3, NC, NQ), scal (2,) = [kth, maxd2]."""
    rng = np.random.default_rng(0)
    q = rng.uniform(-40, 40, size=(nq, 3)).astype(np.float32)
    cand = q[None, :, :] + rng.normal(0, 0.3, size=(nc, nq, 3)).astype(np.float32)
    shifted = q + np.asarray(SHIFT, np.float32)  # f32 adds, as the JAX probe's
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return dict(
        q=t(shifted.T), qmask=torch.ones(nq, dtype=torch.bool, device=device),
        cand=t(cand.transpose(2, 0, 1)),
        scal=torch.tensor([0.5, 4.0], dtype=torch.float32, device=device),
    )


def _kernel_row(probe, name, kernel, args, device, check, library=None, lib_fn=None,
                reads=None, n_ops=0.0, history=None) -> dict:
    """Run one kernel case: its output against its plain version (on the
    CPU the wrapper is the plain version), `check(out, plain)` for
    `correct`, the kernel's and the library call's three times (taken in
    turns, `_times_in_turns`) and the plain version's time; `history` =
    (name, fn) of an earlier yardstick, timed in the same turns. `bytes`
    and `ops` are what a bound on the card needs: `reads` bytes (by
    default every input once) and the output written once."""
    fn, plain = getattr(kp, kernel), getattr(kp, kernel + "_plain")
    out = fn(*args)
    on_card = device.type == "cuda"
    ref = plain(*args) if on_card else out
    yardsticks = [f for f in (lib_fn, history and history[1]) if f]
    t, *others = _times_in_turns([lambda: fn(*args), *yardsticks], device)
    lib = others[0] if lib_fn else dict(ms=None, device_ms=None, host_ms=None)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return dict(
        probe=probe, name=name, kernel=kernel, out=out, **t,
        plain_ms=_ms(lambda: plain(*args), device) if on_card else t["ms"],
        library=library, **{f"library_{k}": v for k, v in lib.items()},
        history=(history[0], others[-1]) if history else None,
        max_abs_err=float((out.double() - ref.double()).abs().max()),
        correct=bool(check(out, ref)),
        bytes=(_nbytes(*tensors) if reads is None else reads) + _nbytes(out), ops=n_ops,
    )


def _gather_check(want: np.ndarray):
    """Equal to numpy's gather, and bit-equal to the plain version."""
    return lambda out, ref: (out.dtype == ref.dtype and torch.equal(out, ref)
                             and np.array_equal(out.cpu().numpy(), want))


def _gather_reads(idx: torch.Tensor, n_unique: int, elem_bytes: int) -> int:
    """A gather reads its index and, once each, the table entries it hits."""
    return _nbytes(idx) + n_unique * elem_bytes


def _library_row(probe, name, library, fn, device) -> dict:
    return dict(probe=probe, name=name, kernel=None, ms=_ms(fn, device), library=library,
                correct=True)


def probe_gather(device) -> list[dict]:
    x = gather_inputs(device)
    table, idx, table2, idx2 = x["table"], x["idx"], x["table2"], x["idx2"]
    flat, lanes = idx[:, 0].long(), idx2.long()
    i, i2 = idx.cpu().numpy(), idx2.cpu().numpy()
    want = table.cpu().numpy()[i[:, 0]]
    want2 = np.take_along_axis(table2.cpu().numpy(), i2, axis=1)
    hit2 = sum(len(np.unique(r)) for r in i2)  # (row, lane) entries read
    return [
        _kernel_row("P1", "take(axis=0) row gather", "take_rows", (table, idx), device,
                    _gather_check(want), "torch.index_select",
                    lambda: torch.index_select(table, 0, flat),
                    reads=_gather_reads(idx, len(np.unique(i)) * W, 4)),
        _kernel_row("P2", "take_along_axis(axis=1) lane gather", "take_lanes", (table2, idx2),
                    device, _gather_check(want2), "torch.gather",
                    lambda: torch.gather(table2, 1, lanes), reads=_gather_reads(idx2, hit2, 4)),
    ]


def probe_gn(device) -> list[dict]:
    x = gn_inputs(device)
    args = (x["q"], x["qmask"], x["cand"], x["scal"], N_INNER)
    undo = -np.asarray(SHIFT)

    def check(out, ref):
        # 8 iterations undo part of the shift: the translation must point
        # along -SHIFT; on the card the kernel must also match its plain
        # version (on the CPU `ref` is `out`)
        o, p = out.cpu().numpy(), ref.cpu().numpy()
        t = o[9:12].astype(np.float64)
        return bool(np.isfinite(o).all()
                    and t @ undo > 0.9 * np.linalg.norm(t) * np.linalg.norm(undo)
                    and np.abs(o[:12] - p[:12]).max() <= GN_TOL and o[12] == p[12])

    # _gn_bound's count: 8 f32 operations per query and slot plus 40 per
    # query, for every one of the n_inner iterations the kernel runs
    return [_kernel_row("P3", f"fused GN kernel ({N_INNER} iters)", "gn_proto", args, device,
                        check, n_ops=N_INNER * NQ * (8.0 * NC + 40.0))]


def probe_gather2(device) -> list[dict]:
    x = gather2_inputs(device)
    i1 = x["idx1"].cpu().numpy()[:, 0]
    flat, big = x["idx1"][:, 0].long(), x["big_idx"].long()
    hit = len(np.unique(i1))  # table rows read
    rows = []
    for name, table, idx in (("taa axis=0 (C,128)->(N,128)", x["table"], x["idx"]),
                             ("taa axis=0 (C,512)->(N,512)", x["table2"], x["idxw"])):
        # the same function: torch.gather on axis 0 by the (N, W) index,
        # made long outside the timed calls
        wide = idx.long()
        rows.append(_kernel_row(
            "P4", name, "take_rows", (table, idx), device,
            _gather_check(table.cpu().numpy()[i1]), "torch.gather",
            lambda table=table, wide=wide: torch.gather(table, 0, wide),
            reads=_gather_reads(idx, hit * table.shape[1], 4),
            history=("torch.index_select", lambda table=table: torch.index_select(table, 0, flat))))
    rows.append(_kernel_row(
        "P4", "taa axis=0 i32 + in-kernel broadcast", "take_rows", (x["ktab"], x["idx1"]), device,
        _gather_check(x["ktab"].cpu().numpy()[i1]), "torch.index_select",
        lambda: torch.index_select(x["ktab"], 0, flat),
        reads=_gather_reads(x["idx1"], hit * x["ktab"].shape[1], 4)))
    for name, table in (("library gather 32k x (30,) f32 rows", x["tab30"]),
                        ("library gather 32k x (15,) i64 rows", x["tab15"])):
        rows.append(_library_row("P4", name, "torch.index_select",
                                 lambda table=table: torch.index_select(table, 0, big), device))
    return rows


PROBES = {"gather": probe_gather, "gn": probe_gn, "gather2": probe_gather2}


def _split(ms, dev_ms, host) -> str:
    """'ms' alone off the card; 'ms (device d, host h)' on it."""
    return f"{ms:.4f} ms" + ("" if dev_ms is None else f" (device {dev_ms:.4f}, host {host:.4f})")


def _line(r: dict) -> str:
    if r["kernel"] is None:
        return f"{r['probe']} {r['name']} ({r['library']}): {r['ms']:.4f} ms  correct=True"
    lib = (f"{r['library']} " + _split(r["library_ms"], r["library_device_ms"],
                                       r["library_host_ms"])
           if r["library"] else "no library call")
    if r["history"]:
        name, t = r["history"]
        lib += f"  [{name} {_split(t['ms'], t['device_ms'], t['host_ms'])}]"
    return (f"{r['probe']} {r['name']} [{r['kernel']}]: "
            f"{_split(r['ms'], r['device_ms'], r['host_ms'])}  plain {r['plain_ms']:.4f} ms  "
            f"{lib}  max|d| {r['max_abs_err']:.3g}  correct={r['correct']}")


def run(which: str, device, out=sys.stdout) -> list[dict]:
    """Run one probe group (or "all") on `device`, print one line per probe
    and return the rows (probe, name, kernel, ms, library, correct; a
    kernel's row also out, device_ms, host_ms, plain_ms, library_ms,
    library_device_ms, library_host_ms, history, max_abs_err, bytes,
    ops)."""
    device = torch.device(device)
    rows = []
    for key in (PROBES if which == "all" else (which,)):
        for r in PROBES[key](device):
            print(_line(r), file=out)
            rows.append(r)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lidar_imu_slam_tpu_torch.tools.probes",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("which", choices=["gather", "gn", "gather2", "all"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = torch.device(a.device)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(dev))
    rows = run(a.which, dev)
    return 0 if all(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

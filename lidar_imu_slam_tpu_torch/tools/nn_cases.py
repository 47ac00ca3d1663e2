"""Seeded adversarial inputs for kernel K6 (`nn_bruteforce`): the cases its
filter and exact re-check must get bit-equal to the plain version. The CPU
tests (tests/test_torch_nn_bruteforce.py) hold the filter's margin and an
emulation of the kernel's algorithm on every case; the card tests
(tests/test_torch_cuda_kernels.py) and chip_smoke.py run every case
through the kernel and the plain version.

`make(case, n, m, seed)` returns (queries (n, 3) f32, pool (3, m) f32) as
numpy arrays, built around a base pool (uniform in a 60 m box, 30% +inf):

* far: coordinates up to 1e4 m, queries within ~1 m of pool points;
* near_ties: for each of the first queries, pool entries at nearly the
  same distance (a 0.5 m sphere, d^2 a few ulps apart, exact duplicates
  among them), spread over slices and groups with the nearest last;
* slice_ties: pairs of entries mirrored about a query (equal d^2 exactly)
  and exact copies of one point, in different 8192-entry slices;
* on_point: queries exactly on pool points, each point also at a later
  index;
* nonfinite_queries: queries with a NaN, +inf or -inf coordinate;
* all_inf: a pool with nothing finite (+inf and -inf coordinates);
* huge: entries and queries beyond the filter's 2^60 range (3e18 m)
  beside ordinary ones;
* offset: the scene 5 km from the origin, where |q|^2 dominates the margin;
* nan_entries: 2% of the entries with a NaN coordinate, and for each of
  the first queries a NaN entry just before its nearest entry (in the same
  32-entry group) and another earlier in the pool: a NaN entry never wins
  and hides nothing.
"""

from __future__ import annotations

import numpy as np

CASES = ("far", "near_ties", "slice_ties", "on_point", "nonfinite_queries", "all_inf", "huge",
         "offset", "nan_entries")


def _base(rng, n, m, half=30.0):
    pool = rng.uniform(-half, half, (m, 3)).astype(np.float32)
    pool[rng.uniform(size=m) < 0.3] = np.inf
    q = rng.uniform(-half, half, (n, 3)).astype(np.float32)
    return q, pool


def _spread(rng, m, k):
    """k distinct pool indices spread over the slices, in increasing order."""
    return np.sort(rng.choice(m, k, replace=False))


def make(case: str, n: int, m: int, seed: int = 0):
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}")
    rng = np.random.default_rng([seed, CASES.index(case)])
    q, pool = _base(rng, n, m)
    few = min(n, 32)
    if case == "far":
        pool = rng.uniform(-1e4, 1e4, (m, 3)).astype(np.float32)
        pool[rng.uniform(size=m) < 0.3] = np.inf
        live = np.flatnonzero(np.isfinite(pool[:, 0]))
        q = (pool[rng.choice(live, n)] + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    elif case == "near_ties":
        pool[np.isfinite(pool[:, 0])] += np.float32(100.0)  # every other entry far away
        per = 8
        for i in range(few):
            u = rng.normal(size=(per, 3))
            pts = (q[i] + 0.5 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
            pts[-1] = pts[0]  # an exact duplicate, at another index
            d = pts.astype(np.float64) - q[i]
            order = np.argsort(-(d * d).sum(1), kind="stable")  # the nearest last
            pool[_spread(rng, m, per)] = pts[order]
    elif case == "slice_ties":
        for i in range(few):
            v = rng.integers(-3, 4, 3).astype(np.float32) * np.float32(0.25)
            v[0] = np.float32(0.5) if not v.any() else v[0]
            a, b, c = _spread(rng, m, 3)
            pool[a], pool[b] = q[i] + v, q[i] - v  # equal d^2, exactly
            pool[c] = q[i] + v  # the first point again, later
    elif case == "on_point":
        live = np.flatnonzero(np.isfinite(pool[:, 0]) & (np.arange(m) < m // 2))
        src = rng.choice(live, n)
        q = pool[src].copy()
        later = rng.integers(m // 2, m, n)
        pool[later] = pool[src]
    elif case == "nonfinite_queries":
        for i, bad in enumerate((np.nan, np.inf, -np.inf) * (few // 3)):
            q[i, i % 3] = bad
        q[few - 1] = np.nan
    elif case == "all_inf":
        pool = np.full((m, 3), np.inf, np.float32)
        pool[rng.uniform(size=m) < 0.5, 1] = -np.inf
    elif case == "huge":
        big = np.float32(3e18)
        pick = _spread(rng, m, min(m, 64))
        pool[pick] = big + rng.uniform(-1e12, 1e12, (len(pick), 3)).astype(np.float32)
        q[:few // 2] = big + rng.uniform(-1e12, 1e12, (few // 2, 3)).astype(np.float32)
        q[few // 2:few] = rng.uniform(-2e18, 2e18, (few - few // 2, 3)).astype(np.float32)
    elif case == "nan_entries":
        bad = rng.uniform(size=m) < 0.02
        pool[bad, rng.integers(0, 3, int(bad.sum()))] = np.nan
        for i in range(few):
            early, near = _spread(rng, m - 1, 2)
            near -= near % 32 == 31  # its nearest entry in the same group
            pool[early] = np.nan
            pool[near] = np.nan
            pool[near + 1] = q[i] + np.float32(0.01) * (i % 5 + 1)
    else:  # offset
        centre = np.array([5000.0, -3000.0, 20.0], np.float32)
        pool = (pool + centre).astype(np.float32)
        q = (q + centre).astype(np.float32)
    return np.ascontiguousarray(q, np.float32), np.ascontiguousarray(pool.T, np.float32)

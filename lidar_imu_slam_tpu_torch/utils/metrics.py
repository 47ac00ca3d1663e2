"""Per-scan structured metrics (counterpart of the JAX package's
`utils/metrics.py`).

The reference has no metrics counters or timing stats (SURVEY §5). The
runners hand `MetricsLog.append` host values: each run's device outputs
come off the card in one copy at its end (`host/runner.py`), so a record
costs no device read of its own.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch


@dataclass
class MetricsLog:
    """Host-side accumulator for per-scan metrics dictionaries."""

    records: List[Dict[str, Any]] = field(default_factory=list)

    def append(self, scan_index: int, **values) -> None:
        """One record; numbers (Python or numpy scalars) are stored as
        floats, as in the JAX package. A tensor is refused: reading it
        here would be one device read per value."""
        rec = {"scan": scan_index, "wall_time": time.time()}
        for k, v in values.items():
            if isinstance(v, torch.Tensor):
                raise TypeError(f"metric {k!r} is a tensor; hand append host values")
            rec[k] = float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v
        self.records.append(rec)

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        out: Dict[str, float] = {"num_scans": float(len(self.records))}
        keys = [
            k
            for k in self.records[0]
            if isinstance(self.records[0][k], float) and k not in ("wall_time",)
        ]
        for k in keys:
            vals = [r[k] for r in self.records if k in r]
            out[f"{k}_mean"] = sum(vals) / len(vals)
        return out

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec) + "\n")


class StepTimer:
    """Wall-clock p50/p95 tracker for the step."""

    def __init__(self):
        self.samples: List[float] = []

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)

    def percentile(self, p: float) -> float:
        if not self.samples:
            return float("nan")
        s = sorted(self.samples)
        i = min(int(len(s) * p / 100.0), len(s) - 1)
        return s[i]

    @property
    def p50(self) -> float:
        return self.percentile(50)

    @property
    def p95(self) -> float:
        return self.percentile(95)

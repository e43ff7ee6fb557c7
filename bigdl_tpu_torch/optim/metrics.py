"""Per-phase timing counters — the port of ``bigdl_tpu/optim/metrics.py``
(ref: .../optim/Metrics.scala — host-side
aggregated timers for compute / aggregate / get-put weights phases)."""

from __future__ import annotations

from collections import defaultdict


class Metrics:
    def __init__(self):
        self._sums = defaultdict(float)
        self._counts = defaultdict(int)

    def add(self, name: str, seconds: float):
        self._sums[name] += seconds
        self._counts[name] += 1

    def mean(self, name: str) -> float:
        return self._sums[name] / max(self._counts[name], 1)

    def total(self, name: str) -> float:
        return self._sums[name]

    def summary(self) -> str:
        return ", ".join(
            f"{k}: {self._sums[k]:.3f}s/{self._counts[k]}"
            for k in sorted(self._sums))

    def reset(self):
        self._sums.clear()
        self._counts.clear()

"""Mergeable quantile sketch — the port of
``bigdl_tpu/observability/sketch.py``.

Fixed-bucket histograms cannot answer fleet questions: PromQL's
``histogram_quantile`` interpolates inside whatever bucket the rank
falls in, so a p99 read off DEFAULT_BUCKETS can be off by the full
bucket width — and two workers' histograms only merge if someone
thought to give them identical bounds. The serving roadmap (p50/p95/p99
TTFT and inter-token latency, ROADMAP item 4; the Ragged Paged
Attention evaluation metrics, arXiv 2604.15464) needs percentiles that
are (a) accurate to a *stated relative error* and (b) exactly
mergeable across workers.

:class:`QuantileSketch` is a DDSketch-style log-bucketed sketch
("DDSketch: a fast and fully-mergeable quantile sketch with
relative-error guarantees", VLDB'19):

- a positive value ``v`` lands in bucket ``ceil(log_gamma(v))`` with
  ``gamma = (1+alpha)/(1-alpha)`` — every value in a bucket is within
  relative error ``alpha`` of the bucket's representative value;
- quantiles walk the cumulative bucket counts to the target rank and
  return the representative, so ``quantile(q)`` is within ``alpha``
  *relative* error of the exact rank-``q`` sample at every scale
  (microsecond stalls and minute-long prefills share one sketch);
- two sketches with the same ``gamma`` merge by summing buckets —
  ``merge`` is lossless: the merged sketch is bit-identical to the
  sketch that would have observed the pooled samples. That is the
  property the federation layer rests on.

Values at or below ``MIN_POSITIVE`` (sub-nanosecond latencies, zeros)
share an exact zero bucket; negatives are counted there too (latencies
are never negative; a clock skew artifact must not corrupt the log
buckets).

``to_snapshot``/``from_snapshot`` round-trip the full state through a
JSON-able dict — the wire format of ``GET /metrics/snapshot`` and the
BENCH telemetry block. Everything is plain host python with no
observability-switch coupling; gating lives in the
:class:`~bigdl_tpu_torch.observability.metrics.Sketch` instrument that wraps
one of these per labeled series.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

#: Values at or below this are exact zeros for sketching purposes.
MIN_POSITIVE = 1e-9

#: Default relative-error bound (1%): p99 of a 100 ms latency is
#: resolved to ±1 ms, at ~275 buckets per decade-spanning workload.
DEFAULT_ALPHA = 0.01


def default_alpha() -> float:
    """The configured relative-error bound
    (``bigdl.observability.sketch.alpha``, default 0.01)."""
    try:
        from bigdl_tpu_torch.utils.conf import conf
        return conf.get_float("bigdl.observability.sketch.alpha",
                              DEFAULT_ALPHA)
    except Exception:
        return DEFAULT_ALPHA


class QuantileSketch:
    """Log-bucketed quantile sketch with bounded relative error.

    Thread-safe: one lock per sketch, same cost model as the histogram
    child (``observe`` is a log, a ceil and a dict increment).
    """

    __slots__ = ("alpha", "gamma", "_log_gamma", "_lock", "_buckets",
                 "_zero", "_count", "_sum", "_min", "_max")

    def __init__(self, alpha: Optional[float] = None):
        alpha = float(alpha if alpha is not None else default_alpha())
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = alpha
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- write side ----------------------------------------------------------
    def observe(self, value: float):
        value = float(value)
        if math.isnan(value):
            return
        with self._lock:
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value
            if value <= MIN_POSITIVE:
                self._zero += 1
                return
            idx = math.ceil(math.log(value) / self._log_gamma)
            self._buckets[idx] = self._buckets.get(idx, 0) + 1

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch in place. Requires the same
        ``gamma`` — merging mismatched bucket bases would silently void
        the error bound, so it raises instead."""
        if abs(other.gamma - self.gamma) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different gamma "
                f"({self.gamma} vs {other.gamma}): re-observe instead")
        with other._lock:
            buckets = dict(other._buckets)
            zero, count = other._zero, other._count
            total, mn, mx = other._sum, other._min, other._max
        with self._lock:
            for idx, c in buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + c
            self._zero += zero
            self._count += count
            self._sum += total
            if mn < self._min:
                self._min = mn
            if mx > self._max:
                self._max = mx
        return self

    # -- read side -----------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def min(self) -> Optional[float]:
        with self._lock:
            return None if self._count == 0 else self._min

    @property
    def max(self) -> Optional[float]:
        with self._lock:
            return None if self._count == 0 else self._max

    def quantile(self, q: float) -> Optional[float]:
        """The rank-``ceil(q*count)`` sample's bucket representative —
        within ``alpha`` relative error of the exact nearest-rank
        quantile. ``None`` when the sketch is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            if self._count == 0:
                return None
            rank = max(int(math.ceil(q * self._count)), 1)
            if rank <= self._zero:
                return 0.0
            cum = self._zero
            for idx in sorted(self._buckets):
                cum += self._buckets[idx]
                if cum >= rank:
                    # bucket (gamma^(i-1), gamma^i]: the midpoint
                    # representative 2*gamma^i/(gamma+1) is within
                    # alpha of every member
                    return (2.0 * self.gamma ** idx
                            / (self.gamma + 1.0))
            # float edge: rank rounded past the last bucket
            return self._max

    def quantiles(self, qs=(0.5, 0.9, 0.95, 0.99)) -> Dict[float, Optional[float]]:
        return {q: self.quantile(q) for q in qs}

    # -- wire format ---------------------------------------------------------
    def to_snapshot(self) -> dict:
        """JSON-able full state (bucket keys become strings — JSON has
        no int keys)."""
        with self._lock:
            return {
                "alpha": self.alpha,
                "gamma": self.gamma,
                "zero": self._zero,
                "count": self._count,
                "sum": self._sum,
                "min": (None if self._count == 0 else self._min),
                "max": (None if self._count == 0 else self._max),
                "buckets": {str(i): c for i, c in self._buckets.items()},
            }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "QuantileSketch":
        sk = cls(alpha=float(snap["alpha"]))
        sk._zero = int(snap.get("zero", 0))
        sk._count = int(snap.get("count", 0))
        sk._sum = float(snap.get("sum", 0.0))
        mn, mx = snap.get("min"), snap.get("max")
        sk._min = math.inf if mn is None else float(mn)
        sk._max = -math.inf if mx is None else float(mx)
        sk._buckets = {int(i): int(c)
                       for i, c in (snap.get("buckets") or {}).items()}
        return sk

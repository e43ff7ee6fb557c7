"""Metric registry + Prometheus text exposition — the port of
``bigdl_tpu/observability/metrics.py``; the exposition text is byte for
byte the JAX package's for the same observations.

The runtime-signal layer the north star needs: one process-wide
registry that training, serving and the LLM engine all write into, rendered
on demand in the Prometheus text exposition format (v0.0.4) so any scraper
can consume `GET /metrics` from the serving front-ends.

Three instrument kinds, mirroring the Prometheus client-library core:

- :class:`Counter`  — monotonically increasing total (``_total`` suffix by
  convention; rendering does not enforce it);
- :class:`Gauge`    — a value that goes up and down (queue depth, occupancy);
- :class:`Histogram` — fixed cumulative buckets + ``_sum``/``_count``,
  the shape PromQL's ``histogram_quantile`` expects.

Labeled series: every instrument is declared once with its label *names*;
``labels(**kv)`` returns (and memoizes) the child series for one label
*value* tuple. Unlabeled instruments are their own single child.

Thread safety: one lock per instrument child for mutation, one registry
lock for declaration — the hot-path cost of ``inc()`` is an attribute
read (the global enable flag), a lock acquire and a float add. There are
NO background threads and NO device interactions here; everything is
plain host python, so instrumenting a device-driven loop adds zero host↔
device synchronization points.

Disabled mode: when :func:`bigdl_tpu_torch.observability.enabled` is False every
mutator returns immediately without touching state — the no-op mode the
overhead bound requires (tests assert zero entries appear).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.observability import _state
from bigdl_tpu_torch.observability.sketch import QuantileSketch

#: HTTP Content-Type of the text exposition format — the one string
#: every /metrics endpoint must agree on.
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Quantiles a Sketch instrument renders as Prometheus summary series.
SUMMARY_QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.95, 0.99)

# Prometheus default buckets are tuned for request latency in seconds;
# training steps and decode steps live in the same range.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    .0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
    1.0, 2.5, 5.0, 10.0, 30.0)

#: Sub-millisecond work — the pipelined engine's host-side scheduling
#: slice and its device-fence stalls live at 10 µs..10 ms,
#: below DEFAULT_BUCKETS' useful resolution.
FAST_BUCKETS: Tuple[float, ...] = (
    .00001, .000025, .00005, .0001, .00025, .0005, .001, .0025,
    .005, .01, .025, .05, .1, .5)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    # repr(float) round-trips; integers render without the trailing .0
    # noise that would make counters read oddly
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_suffix(names: Sequence[str], values: Sequence[str],
                   extra: Optional[List[Tuple[str, str]]] = None) -> str:
    pairs = [(n, v) for n, v in zip(names, values)]
    if extra:
        pairs += extra
    if not pairs:
        return ""
    inner = ",".join(f'{n}="{_escape_label_value(str(v))}"'
                     for n, v in pairs)
    return "{" + inner + "}"


class _Child:
    """One labeled series of an instrument (or the sole series when the
    instrument is unlabeled)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0):
        if not _state.enabled:
            return
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float):
        if not _state.enabled:
            return
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        if not _state.enabled:
            return
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float]):
        self._lock = threading.Lock()
        self._buckets = tuple(buckets)
        self._counts = [0] * len(self._buckets)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float):
        if not _state.enabled:
            return
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            # bucket-local counts; snapshot() cumulates for exposition
            for i, b in enumerate(self._buckets):
                if value <= b:
                    self._counts[i] += 1
                    break

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(cumulative bucket counts incl. +Inf, sum, count)."""
        with self._lock:
            cum, running = [], 0
            for c in self._counts:
                running += c
                cum.append(running)
            cum.append(self._count)          # the +Inf bucket
            return cum, self._sum, self._count

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-quantile from bucket boundaries (the same linear
        interpolation PromQL's histogram_quantile applies). None when
        empty."""
        cum, _, count = self.snapshot()
        if count == 0:
            return None
        rank = q * count
        prev_bound, prev_cum = 0.0, 0
        for bound, c in zip(self._buckets, cum):
            if c >= rank:
                if c == prev_cum:
                    return bound
                frac = (rank - prev_cum) / (c - prev_cum)
                return prev_bound + frac * (bound - prev_bound)
            prev_bound, prev_cum = bound, c
        return self._buckets[-1] if self._buckets else None


class _SketchChild:
    """One labeled series of a :class:`Sketch`: a
    :class:`~bigdl_tpu_torch.observability.sketch.QuantileSketch` behind the
    global observability switch (the sketch itself is switch-agnostic,
    so federation can build merge scratch sketches freely)."""

    __slots__ = ("sketch",)

    def __init__(self, alpha: Optional[float]):
        self.sketch = QuantileSketch(alpha=alpha)

    def observe(self, value: float):
        if not _state.enabled:
            return
        self.sketch.observe(value)

    @property
    def count(self) -> int:
        return self.sketch.count

    @property
    def sum(self) -> float:
        return self.sketch.sum

    def quantile(self, q: float) -> Optional[float]:
        return self.sketch.quantile(q)

    def to_snapshot(self) -> dict:
        return self.sketch.to_snapshot()


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._default = self._make_child()
            self._children[()] = self._default

    def _make_child(self):
        raise NotImplementedError

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name} declared labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def children(self) -> Iterable[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())

    # unlabeled sugar: counter.inc() / gauge.set() without .labels()
    def _sole(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} has labels {self.labelnames}; call "
                f".labels(...) first")
        return self._default


class Counter(_Instrument):
    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0):
        self._sole().inc(amount)

    @property
    def value(self) -> float:
        return self._sole().value


class Gauge(_Instrument):
    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def set(self, value: float):
        self._sole().set(value)

    def inc(self, amount: float = 1.0):
        self._sole().inc(amount)

    def dec(self, amount: float = 1.0):
        self._sole().dec(amount)

    @property
    def value(self) -> float:
        return self._sole().value


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(x for x in b if not math.isinf(x))
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, value: float):
        self._sole().observe(value)

    def percentile(self, q: float) -> Optional[float]:
        return self._sole().percentile(q)

    @property
    def count(self) -> int:
        return self._sole().count

    @property
    def sum(self) -> float:
        return self._sole().sum


class Sketch(_Instrument):
    """Mergeable quantile instrument: one
    :class:`~bigdl_tpu_torch.observability.sketch.QuantileSketch` per labeled
    series, rendered as Prometheus **summary** quantiles. Unlike a
    Histogram its percentiles carry a stated relative-error bound
    (``alpha``) and two workers' series merge losslessly — the signal
    type the federation layer aggregates."""

    kind = "summary"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = (),
                 alpha: Optional[float] = None):
        # resolve now so every child (and any merge peer) shares gamma
        from bigdl_tpu_torch.observability.sketch import default_alpha
        self.alpha = float(alpha if alpha is not None
                           else default_alpha())
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _SketchChild(self.alpha)

    def observe(self, value: float):
        self._sole().observe(value)

    def quantile(self, q: float) -> Optional[float]:
        return self._sole().quantile(q)

    @property
    def count(self) -> int:
        return self._sole().count

    @property
    def sum(self) -> float:
        return self._sole().sum

    def to_snapshot(self) -> dict:
        return self._sole().to_snapshot()


class MetricRegistry:
    """Declaration point + exposition surface. Declaring the same name
    twice returns the existing instrument (so module-level hot paths can
    declare lazily without coordination); re-declaring with a different
    kind or label set is a programming error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}

    def _declare(self, cls, name: str, help: str,
                 labelnames: Sequence[str] = (), **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or \
                        existing.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} already declared as "
                        f"{existing.kind}{existing.labelnames}")
                want_buckets = kw.get("buckets")
                if want_buckets is not None and \
                        existing.buckets != tuple(
                            sorted(float(b) for b in want_buckets
                                   if not math.isinf(b))):
                    raise ValueError(
                        f"histogram {name} already declared with "
                        f"buckets {existing.buckets}")
                want_alpha = kw.get("alpha")
                if want_alpha is not None and \
                        abs(existing.alpha - float(want_alpha)) > 1e-12:
                    raise ValueError(
                        f"sketch {name} already declared with "
                        f"alpha {existing.alpha}")
                return existing
            m = cls(name, help, labelnames=labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, labelnames,
                             buckets=buckets)

    def sketch(self, name: str, help: str = "",
               labelnames: Sequence[str] = (),
               alpha: Optional[float] = None) -> Sketch:
        return self._declare(Sketch, name, help, labelnames, alpha=alpha)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[_Instrument]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def sample_value(self, name: str, **labels) -> Optional[float]:
        """Read one series' current value (a histogram's or sketch's
        count) — tests and report tooling; None when it does not exist."""
        m = self.get(name)
        if m is None:
            return None
        key = tuple(str(labels[n]) for n in m.labelnames) \
            if m.labelnames else ()
        for k, child in m.children():
            if k == key:
                if isinstance(child, (_HistogramChild, _SketchChild)):
                    return float(child.count)
                return child.value
        return None

    def clear(self):
        """Drop every declaration — test isolation only; live code holds
        instrument references that would silently detach."""
        with self._lock:
            self._metrics.clear()

    def render(self) -> str:
        return render_prometheus(self)


def render_prometheus(registry: MetricRegistry) -> str:
    """Prometheus text exposition format v0.0.4 of every series in
    ``registry``. Deterministic order (metric name, then label values) so
    the output is diff- and test-friendly."""
    lines: List[str] = []
    for m in registry.collect():
        lines.append(f"# HELP {m.name} {_escape_help(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for key, child in sorted(m.children()):
            if isinstance(child, _HistogramChild):
                cum, total, count = child.snapshot()
                bounds = [_format_value(b) for b in m.buckets] + ["+Inf"]
                for bound, c in zip(bounds, cum):
                    suffix = _labels_suffix(m.labelnames, key,
                                            extra=[("le", bound)])
                    lines.append(f"{m.name}_bucket{suffix} {c}")
                s = _labels_suffix(m.labelnames, key)
                lines.append(f"{m.name}_sum{s} {_format_value(total)}")
                lines.append(f"{m.name}_count{s} {count}")
            elif isinstance(child, _SketchChild):
                # summary exposition: one series per quantile, exact to
                # the sketch's relative-error bound (no bucket
                # interpolation). Empty sketches render NaN like the
                # stock client libraries.
                for q in SUMMARY_QUANTILES:
                    suffix = _labels_suffix(
                        m.labelnames, key,
                        extra=[("quantile", _format_value(q))])
                    v = child.quantile(q)
                    lines.append(
                        f"{m.name}{suffix} "
                        f"{_format_value(v) if v is not None else 'NaN'}")
                s = _labels_suffix(m.labelnames, key)
                lines.append(
                    f"{m.name}_sum{s} {_format_value(child.sum)}")
                lines.append(f"{m.name}_count{s} {child.count}")
            else:
                s = _labels_suffix(m.labelnames, key)
                lines.append(f"{m.name}{s} {_format_value(child.value)}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict[Tuple[Tuple[str, str],
                                                        ...], float]]:
    """Minimal exposition-format parser (the read-back side used by the
    tests and ``tools/telemetry_report.py``): sample name →
    {sorted label tuple: value}. Comment/TYPE/HELP lines are skipped."""
    out: Dict[str, Dict[Tuple[Tuple[str, str], ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, rest = line.split("{", 1)
            labelpart, valuepart = rest.rsplit("}", 1)
            labels = []
            for item in _split_labels(labelpart):
                k, v = item.split("=", 1)
                v = v.strip()
                # drop exactly the enclosing quote pair — strip('"')
                # would also eat an escaped quote at the value's end
                if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
                    v = v[1:-1]
                labels.append((k.strip(), _unescape(v)))
            value = valuepart.strip().split()[0]
        else:
            parts = line.split()
            if len(parts) < 2:
                continue
            name, value = parts[0], parts[1]
            labels = []
        out.setdefault(name.strip(), {})[tuple(sorted(labels))] = \
            float(value)
    return out


def _unescape(s: str) -> str:
    """Single left-to-right scan — sequential .replace() calls corrupt
    values where an escaped backslash precedes an 'n' (r'\\n' would be
    misread as an escaped newline)."""
    out, i = [], 0
    while i < len(s):
        ch = s[i]
        if ch == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(
                nxt, "\\" + nxt))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _split_labels(s: str) -> List[str]:
    """Split `a="x",b="y"` on commas outside quotes."""
    items, buf, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
            buf.append(ch)
            continue
        if ch == "," and not in_q:
            items.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        items.append("".join(buf))
    return [i for i in items if i.strip()]

"""Telemetry of the port — ``bigdl_tpu/observability`` on torch.

One process-wide surface, as in the JAX package:

- :mod:`~bigdl_tpu_torch.observability.metrics` — thread-safe Counter /
  Gauge / Histogram / Sketch registry + Prometheus text exposition
  (``render()``; served by the HTTP worker at ``GET /metrics``), byte
  for byte the JAX package's for the same observations;
- :mod:`~bigdl_tpu_torch.observability.tracing` — ``with span("llm/
  prefill", ...):`` nestable trace spans → ring buffer → Chrome-trace /
  Perfetto JSON, with an optional passthrough to
  ``torch.profiler.record_function`` so the same spans label a torch
  profiler trace;
- :mod:`~bigdl_tpu_torch.observability.request_context` — the trace
  headers and queue wire form, the JAX package's, so a JAX router's
  ``X-BigDL-Trace-Id`` stitches into this process's spans;
- :mod:`~bigdl_tpu_torch.observability.flight` — the engine's decision
  event ring behind ``/debug/flight`` and ``/debug/explain/<id>``;
- :mod:`~bigdl_tpu_torch.observability.slo` — per-request TTFT / ITL
  accounting (``LLMServer(slo=True)``);
- :mod:`~bigdl_tpu_torch.observability.compile_recorder` — the CUDA-graph
  capture records (the JAX package's compile records: the same
  ``bigdl_xla_*`` series, one entry a capture, each step's FLOPs and
  bytes a call reckoned from its shapes);
- :mod:`~bigdl_tpu_torch.observability.utilization` — the live roofline
  gauges (``bigdl_device_mfu``, ``bigdl_device_hbm_bw_gbps``,
  ``bigdl_device_bw_util``) and the per-program table, behind the flight
  switch;
- :mod:`~bigdl_tpu_torch.observability.federation` — the fleet merge
  (``/metrics/snapshot``, the router's collector), behind
  ``bigdl.observability.federation``;
- :mod:`~bigdl_tpu_torch.observability.timeseries` and
  :mod:`~bigdl_tpu_torch.observability.alerts` — the windowed store
  behind ``/metrics/query`` and ``/fleet/timeline``, and the alert
  engine behind ``/alerts``, behind
  ``bigdl.observability.timeseries.enabled``.

The port's registry, ring and switches are its own: both packages can
live in one process (the parity tests do) without sharing a series.
Every metric is prefixed ``bigdl_``. Overhead contract: everything is
host-side python over clocks the engine already reads; the
``bigdl.observability.enabled`` key (env
``BIGDL_TPU_OBSERVABILITY_ENABLED``) or :func:`disable` turns every
mutator and ``span`` into a no-op that records nothing.
"""

from __future__ import annotations

import time as _time

from bigdl_tpu_torch.observability import _state
from bigdl_tpu_torch.observability.metrics import (
    CONTENT_TYPE, Counter, DEFAULT_BUCKETS, FAST_BUCKETS, Gauge,
    Histogram, MetricRegistry, SUMMARY_QUANTILES, Sketch,
    parse_prometheus, render_prometheus)
from bigdl_tpu_torch.observability.sketch import QuantileSketch
from bigdl_tpu_torch.observability import tracing
from bigdl_tpu_torch.observability.tracing import (
    EXEMPLARS, TRACE, TraceBuffer, add_complete, assemble_trace,
    configure, export_chrome_trace, span)
from bigdl_tpu_torch.observability import request_context
from bigdl_tpu_torch.observability.request_context import (
    PARENT_HEADER, TRACE_HEADER, TraceContext)
from bigdl_tpu_torch.observability import compile_recorder
from bigdl_tpu_torch.observability.compile_recorder import compile_stats
from bigdl_tpu_torch.observability import flight
from bigdl_tpu_torch.observability import utilization

#: The process-global registry every built-in hook writes to.
REGISTRY = MetricRegistry()

#: Epoch seconds this module (≈ the process) came up — exported as the
#: standard ``process_start_time_seconds`` so ``time() - start`` uptime
#: panels work against our /metrics unchanged.
PROCESS_START_TIME = _time.time()


def _ensure_standard_series():
    """Declare the self-describing series every Prometheus scrape should
    carry: ``bigdl_build_info`` (value 1, identity as labels — the stock
    *_build_info idiom; the port names torch's version and the backend
    where the JAX package names JAX's) and
    ``process_start_time_seconds``. Called at render time, gated on the
    switch, so a disabled process mints zero series."""
    if not _state.enabled:
        return
    import torch
    from bigdl_tpu_torch import __version__ as version
    g = REGISTRY.gauge(
        "bigdl_build_info",
        "Constant 1; the build identity lives in the labels",
        labelnames=("version", "torch_version", "backend"))
    g.labels(version=version, torch_version=torch.__version__,
             backend="cuda" if torch.cuda.is_available() else "cpu").set(1)
    REGISTRY.gauge(
        "process_start_time_seconds",
        "Unix epoch seconds this process started").set(
        PROCESS_START_TIME)


def enabled() -> bool:
    return _state.enabled


def enable():
    _state.enabled = True


def disable():
    """No-op mode: every inc/set/observe/span becomes a cheap early
    return; nothing is recorded anywhere."""
    _state.enabled = False


def counter(name: str, help: str = "", labelnames=()):
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()):
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(),
              buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, labelnames, buckets)


def sketch(name: str, help: str = "", labelnames=(), alpha=None):
    """Mergeable quantile sketch: observed like a histogram,
    rendered as summary quantiles, merged across workers by the
    federation layer."""
    return REGISTRY.sketch(name, help, labelnames, alpha)


def render() -> str:
    """Prometheus text exposition of the global registry."""
    _ensure_standard_series()
    return render_prometheus(REGISTRY)


def reset():
    """Clear the global registry, the trace ring, the exemplar store,
    the capture records, the flight ring, the roofline window, the alert
    engine and the time-series store. Test isolation only: instruments
    held by live modules detach from the registry."""
    REGISTRY.clear()
    TRACE.clear()
    EXEMPLARS.clear()
    compile_recorder.reset()
    flight.reset()
    utilization.reset()
    from bigdl_tpu_torch.observability import alerts, timeseries
    alerts.reset()
    timeseries.reset()


__all__ = [
    "CONTENT_TYPE", "Counter", "EXEMPLARS", "Gauge", "Histogram",
    "MetricRegistry", "PARENT_HEADER", "PROCESS_START_TIME",
    "QuantileSketch", "REGISTRY", "SUMMARY_QUANTILES", "Sketch",
    "TRACE", "TRACE_HEADER", "TraceBuffer", "TraceContext",
    "DEFAULT_BUCKETS", "FAST_BUCKETS", "add_complete", "assemble_trace",
    "compile_recorder", "compile_stats", "configure",
    "counter", "disable", "enable", "enabled", "export_chrome_trace",
    "flight", "gauge", "histogram", "parse_prometheus", "render",
    "render_prometheus", "request_context", "reset", "sketch", "span",
    "tracing", "utilization",
]

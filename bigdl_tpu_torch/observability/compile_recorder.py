"""CUDA-graph capture records — the port of
``bigdl_tpu/observability/compile_recorder.py``.

Where the JAX package compiles a step (``jax.jit``), the port captures
it into a CUDA graph (:class:`~bigdl_tpu_torch.llm.graphs.CapturedStep`).
Each capture records one entry here under the step's program name — the
JAX engine's names (``llm/decode_paged``, ``llm/step_mixed``,
``llm/step_spec``, ``llm/decode_slotted``, …), so both packages' tables
read alike — with its capture seconds, its graph pool bytes and its
kernel launches a replay, and the series keep the JAX names and labels
so a mixed fleet merges:

- ``bigdl_xla_compiles_total{fn}`` / ``bigdl_xla_compile_seconds{fn}``
  — captures and their wall time per program;
- ``bigdl_xla_recompiles_total{fn}`` — captures of one step beyond its
  first (a step captured again after ``close()``);
- ``bigdl_xla_flops_per_call{fn}`` / ``bigdl_xla_bytes_accessed_per_call
  {fn}`` — the step's FLOPs and bytes a call at no live token (below);
- ``bigdl_xla_peak_hbm_bytes{fn}`` — the graph's private pool: the
  device memory its temporaries hold;
- ``bigdl_xla_live_buffer_bytes`` — ``torch.cuda.memory_allocated`` at
  the capture.

What a call costs is reckoned from the step's shapes, as
``chip_smoke.py``'s bound column reckons a kernel's (no profiler, no
device read), and stated to :func:`record_capture` by the engine
(``serving.step_costs``):

- bytes: every linear's weight planes (packed q4_0 codes and scales,
  or a dense matrix), the head included, each read once; plus the K/V
  of every key a call attends, read once (``kv_bytes`` a key);
- FLOPs: 2 x rows x weight elements; plus 4 x query heads x head dim x
  layers for each (query, key) pair attended (``attn_flops`` a pair).

The fixed part is :func:`latest_costs` (what the JAX function returns:
``{fn: (flops, bytes)}``), the per-key part :func:`attn_costs`; the
engine passes the keys and pairs a call attended, host values its
drain already holds, to :func:`~bigdl_tpu_torch.observability.
utilization.observe`. A mixture-of-experts layer counts every expert's
weights (an upper bound on its FLOPs at a small batch).

On the CPU nothing is captured and the records stay empty, as the JAX
package's do before a compile. Recording is host code after the
capture: nothing here runs inside a replay.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

#: Capture times live in a very different range from request latency
#: (the JAX package's compile buckets).
COMPILE_BUCKETS: Tuple[float, ...] = (
    .01, .05, .1, .25, .5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
    300.0, 600.0)

# process-global capture ledger, keyed by program name; history capped
# per name
_stats_lock = threading.Lock()
_stats: Dict[str, Dict[str, Any]] = {}
_HISTORY_CAP = 64


def _instruments():
    from bigdl_tpu_torch import observability as obs
    return {
        "compiles": obs.counter(
            "bigdl_xla_compiles_total",
            "CUDA-graph captures per engine step (the JAX package counts "
            "XLA compilations here)",
            labelnames=("fn",)),
        "recompiles": obs.counter(
            "bigdl_xla_recompiles_total",
            "Captures of one step beyond its first (a step captured again "
            "after it was closed)",
            labelnames=("fn",)),
        "compile_seconds": obs.histogram(
            "bigdl_xla_compile_seconds",
            "Wall time of one CUDA-graph capture",
            labelnames=("fn",), buckets=COMPILE_BUCKETS),
        "flops": obs.gauge(
            "bigdl_xla_flops_per_call",
            "FLOPs of one call of the captured step at no live token, "
            "reckoned from its shapes",
            labelnames=("fn",)),
        "bytes": obs.gauge(
            "bigdl_xla_bytes_accessed_per_call",
            "Bytes one call of the captured step reads and writes at no "
            "live token (its weights), reckoned from its shapes",
            labelnames=("fn",)),
        "peak_hbm": obs.gauge(
            "bigdl_xla_peak_hbm_bytes",
            "Device memory the captured graph's private pool holds",
            labelnames=("fn",)),
        "live_bytes": obs.gauge(
            "bigdl_xla_live_buffer_bytes",
            "torch.cuda.memory_allocated, sampled at capture time"),
    }


def record_capture(fn: str, seconds: float, pool_bytes: int,
                   launches: Dict[str, int],
                   costs: Optional[Dict[str, float]] = None,
                   signature: str = "", recapture: bool = False):
    """One capture of step ``fn``: its wall ``seconds``, its graph pool
    bytes, its launches a replay (by counter) and, when the engine
    reckoned them, its ``costs`` (``flops`` / ``bytes`` a call at no
    live token, ``attn_flops`` a (query, key) pair, ``kv_bytes`` a
    key). ``recapture``: the step was captured before. Observability
    off records nothing, as the JAX recorder then compiles nothing of
    its own."""
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.observability import tracing
    if not obs.enabled():
        return
    entry: Dict[str, Any] = {
        "signature": signature, "capture_s": round(seconds, 4),
        "pool_bytes": int(pool_bytes), "launches": dict(launches)}
    if costs:
        entry.update({"flops": float(costs.get("flops", 0.0)),
                      "bytes_accessed": float(costs.get("bytes", 0.0)),
                      "attn_flops": float(costs.get("attn_flops", 0.0)),
                      "kv_bytes": float(costs.get("kv_bytes", 0.0))})
    with _stats_lock:
        rec = _stats.setdefault(fn, {"fn": fn, "compiles": 0,
                                     "recompiles": 0, "history": []})
        rec["compiles"] += 1
        rec["recompiles"] += int(recapture)
        rec["history"].append(entry)
        del rec["history"][:-_HISTORY_CAP]
    ins = _instruments()
    ins["compiles"].labels(fn=fn).inc()
    ins["compile_seconds"].labels(fn=fn).observe(seconds)
    if recapture:
        ins["recompiles"].labels(fn=fn).inc()
    if costs:
        ins["flops"].labels(fn=fn).set(entry["flops"])
        ins["bytes"].labels(fn=fn).set(entry["bytes_accessed"])
    ins["peak_hbm"].labels(fn=fn).set(int(pool_bytes))
    try:
        import torch
        if torch.cuda.is_available():
            ins["live_bytes"].set(torch.cuda.memory_allocated())
    except Exception:   # noqa: BLE001 — telemetry never breaks a capture
        pass
    tracing.add_complete("xla/compile", time.time() - seconds, seconds,
                         fn=fn, signature=signature, stage="xla",
                         recompile=recapture)


def reset():
    """Clear the process-global capture ledger — test isolation only."""
    with _stats_lock:
        _stats.clear()


def _latest(keys: Tuple[str, str]) -> Dict[str, Tuple[float, float]]:
    out: Dict[str, Tuple[float, float]] = {}
    with _stats_lock:
        for name, rec in _stats.items():
            for entry in reversed(rec["history"]):
                if keys[0] in entry or keys[1] in entry:
                    out[name] = (float(entry.get(keys[0], 0.0)),
                                 float(entry.get(keys[1], 0.0)))
                    break
    return out


def latest_costs() -> Dict[str, Tuple[float, float]]:
    """``{fn: (flops, bytes_accessed)}`` a call at no live token, from
    the latest capture of each step that carried costs — the join key
    :mod:`~bigdl_tpu_torch.observability.utilization` multiplies by
    measured drain wall times (the JAX function's contract)."""
    return _latest(("flops", "bytes_accessed"))


def attn_costs() -> Dict[str, Tuple[float, float]]:
    """``{fn: (flops a (query, key) pair, bytes a key)}`` of each step's
    attention, from its latest capture."""
    return _latest(("attn_flops", "kv_bytes"))


def compile_stats() -> List[Dict[str, Any]]:
    """The process-wide capture ledger, per program name: captures,
    recaptures and their history (capture s, pool bytes, launches a
    replay, costs)."""
    with _stats_lock:
        return [{"fn": rec["fn"], "compiles": rec["compiles"],
                 "recompiles": rec["recompiles"],
                 "history": [dict(h) for h in rec["history"]]}
                for name, rec in sorted(_stats.items())]


__all__ = ["COMPILE_BUCKETS", "attn_costs", "compile_stats",
           "latest_costs", "record_capture", "reset"]

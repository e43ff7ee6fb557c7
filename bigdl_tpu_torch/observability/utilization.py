"""Live roofline attribution — the port of
``bigdl_tpu/observability/utilization.py``.

The capture records (:mod:`~bigdl_tpu_torch.observability.
compile_recorder`) hold each captured step's FLOPs and bytes a call,
reckoned from its shapes; this module multiplies them by the *measured*
wall time of each drained step (the drain's host dispatch plus its
fence wait: clocks the engine already reads — no new device sync, no
host call in a graphed pass) to derive:

- ``bigdl_device_mfu`` — achieved FLOPs / peak dense bf16 FLOPs over a
  rolling window of sampled dispatches;
- ``bigdl_device_hbm_bw_gbps`` — achieved memory traffic (bytes a call
  per wall second) over the same window;
- ``bigdl_device_bw_util`` — that bandwidth as a fraction of the
  memory's peak: the live measure of a step's distance from its byte
  bound;
- a per-program roofline table attached to ``GET /metrics/snapshot``
  (``"roofline"`` key) naming, for every sampled step, its achieved
  TFLOP/s and GB/s, the utilization fractions and whether it sits on the
  memory or the compute side of the machine-balance line.

A paged step's bytes and FLOPs grow with the keys it attends: the
engine passes them as :func:`observe`'s ``attn=(keys, pairs)`` (keys
read once, (query, key) pairs computed), host values of its in-flight
record, and the step's per-key costs come from :func:`compile_recorder.
attn_costs`. Without ``attn`` the port computes what the JAX function
computes.

Peak specs come from :data:`PEAK_SPECS` (data sheets, matched by
``torch.cuda.get_device_name()`` substring) and are overridable —
mandatory on cards not in the table — via ``bigdl.device.peak.tflops``
/ ``bigdl.device.peak.gbps`` (``0`` = auto-detect). With no match and
no override the ratio gauges stay unset.

Gated with the flight recorder (``bigdl.observability.flight.enabled``):
disabled means :func:`observe` is one attribute check, no window, no
``bigdl_device_*`` series, no snapshot key.
"""

from __future__ import annotations

import functools
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from bigdl_tpu_torch.observability import compile_recorder, flight
from bigdl_tpu_torch.utils.conf import conf

#: (device name substring, peak dense bf16 TFLOP/s, peak memory GB/s)
#: per card — data sheets; first substring match wins (lowercased), so
#: the PCIe and NVL boards come before the SXM part.
PEAK_SPECS: Tuple[Tuple[str, float, float], ...] = (
    ("h100 pcie", 756.0, 2000.0),
    ("h100 nvl", 835.0, 3900.0),
    ("h100", 989.0, 3350.0),     # H100 SXM5 80 GB ("H100 80GB HBM3")
)

#: Gauges are derived over the most recent N sampled dispatches, so a
#: long-idle engine converges to its *current* operating point instead
#: of a lifetime average; the roofline table keeps lifetime totals.
WINDOW = 1024

_lock = threading.Lock()
_window: deque = deque(maxlen=WINDOW)      # (fn, wall_s, keys, pairs)
_totals: Dict[str, Dict[str, float]] = {}  # fn -> calls / wall_s / keys / pairs
_ins: Optional[Dict[str, Any]] = None


@functools.lru_cache(maxsize=None)
def _device_kind() -> str:
    """The card's name, ``cpu`` without one: read once a process (the
    drain's gauge update asks for it at every step)."""
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.get_device_name(0)
        return "cpu"
    except Exception:
        return "unknown"


def peaks() -> Tuple[Optional[float], Optional[float]]:
    """(peak FLOP/s, peak memory GB/s) for this card, or None per axis
    when unknown (no CUDA device or a card not in the table, and no conf
    override) — unknown peaks suppress the ratio gauges rather than
    inventing a roofline."""
    tf = conf.get_float("bigdl.device.peak.tflops", 0.0) or 0.0
    gb = conf.get_float("bigdl.device.peak.gbps", 0.0) or 0.0
    peak_f = tf * 1e12 if tf > 0 else None
    peak_b = gb if gb > 0 else None
    if peak_f is not None and peak_b is not None:
        return peak_f, peak_b
    kind = _device_kind().lower()
    for key, f, b in PEAK_SPECS:
        if key in kind:
            peak_f = peak_f if peak_f is not None else f * 1e12
            peak_b = peak_b if peak_b is not None else b
            break
    return peak_f, peak_b


def _instruments() -> Optional[Dict[str, Any]]:
    global _ins
    from bigdl_tpu_torch import observability as obs
    if not obs.enabled():
        return None
    if _ins is None:
        _ins = {
            "mfu": obs.gauge(
                "bigdl_device_mfu",
                "Achieved flops / peak dense bf16 flops over the recent "
                "sampled-dispatch window"),
            "bw": obs.gauge(
                "bigdl_device_hbm_bw_gbps",
                "Achieved HBM traffic (cost-analysis bytes accessed per "
                "wall second) over the recent sampled-dispatch window"),
            "bw_util": obs.gauge(
                "bigdl_device_bw_util",
                "Achieved HBM bandwidth as a fraction of the platform "
                "peak — the live decode-is-bandwidth-bound alarm"),
        }
    return _ins


def observe(fn: str, wall_s: float,
            attn: Optional[Tuple[int, int]] = None):
    """Attribute one dispatch of step ``fn`` (a name known to the
    capture records) to ``wall_s`` of measured wall time. ``attn``:
    the (keys, pairs) the call attended, for steps whose cost grows
    with the live lengths. Called from the engine's drain; one
    attribute check when the flight gate is off."""
    if not flight.enabled or wall_s <= 0.0:
        return
    keys, pairs = attn if attn is not None else (0, 0)
    with _lock:
        t = _totals.setdefault(fn, {"calls": 0, "wall_s": 0.0,
                                    "keys": 0, "pairs": 0})
        t["calls"] += 1
        t["wall_s"] += wall_s
        t["keys"] += keys
        t["pairs"] += pairs
        _window.append((fn, wall_s, keys, pairs))
    _update_gauges()


def _cost(costs, attn, fn, calls, keys, pairs) -> Optional[Tuple[float,
                                                               float]]:
    """(flops, bytes) of ``calls`` calls of ``fn`` that attended
    ``keys`` / ``pairs`` in all; None without cost records."""
    c = costs.get(fn)
    if c is None:
        return None
    a = attn.get(fn) or (0.0, 0.0)
    return c[0] * calls + a[0] * pairs, c[1] * calls + a[1] * keys


def _update_gauges():
    ins = _instruments()
    if ins is None:
        return
    with _lock:
        entries = list(_window)
    if not entries:
        return
    attn = compile_recorder.attn_costs()
    # each program's (flops, bytes, flops a pair, bytes a key), looked up
    # once here rather than once an entry: the window is summed at every
    # drained step
    per = {fn: (c[0], c[1], *(attn.get(fn) or (0.0, 0.0)))
           for fn, c in compile_recorder.latest_costs().items()}
    wall = flops = nbytes = 0.0
    for fn, w, keys, pairs in entries:
        c = per.get(fn)
        if c is None:
            continue   # no cost record for this program: unattributable
        wall += w
        flops += c[0] + c[2] * pairs
        nbytes += c[1] + c[3] * keys
    if wall <= 0.0:
        return
    gbps = nbytes / wall / 1e9
    ins["bw"].set(gbps)
    peak_f, peak_b = peaks()
    if peak_f:
        ins["mfu"].set(flops / wall / peak_f)
    if peak_b:
        ins["bw_util"].set(gbps / peak_b)


def roofline_table() -> List[Dict[str, Any]]:
    """Lifetime per-program roofline rows, busiest first. A paged step's
    ``flops_per_call`` / ``bytes_per_call`` are its means over the calls
    sampled."""
    with _lock:
        totals = {fn: dict(t) for fn, t in _totals.items()}
    if not totals:
        return []
    costs = compile_recorder.latest_costs()
    attn = compile_recorder.attn_costs()
    peak_f, peak_b = peaks()
    rows: List[Dict[str, Any]] = []
    for fn, t in totals.items():
        calls = int(t["calls"])
        wall = t["wall_s"]
        flops, nbytes = _cost(costs, attn, fn, calls, t["keys"],
                              t["pairs"]) or (0.0, 0.0)
        # a call's fixed cost plus its mean attention (exactly the JAX
        # row when nothing was attended)
        base = costs.get(fn) or (0.0, 0.0)
        a = attn.get(fn) or (0.0, 0.0)
        c = (base[0] + a[0] * t["pairs"] / calls,
             base[1] + a[1] * t["keys"] / calls)
        row: Dict[str, Any] = {
            "fn": fn, "calls": calls, "wall_s": round(wall, 6),
            "flops_per_call": c[0], "bytes_per_call": c[1],
            "achieved_tflops": (round(flops / wall / 1e12, 4)
                                if wall > 0 else 0.0),
            "achieved_gbps": (round(nbytes / wall / 1e9, 3)
                              if wall > 0 else 0.0),
        }
        if wall > 0 and peak_f and flops:
            row["mfu"] = round(flops / wall / peak_f, 4)
        if wall > 0 and peak_b and nbytes:
            row["bw_util"] = round(nbytes / wall / 1e9 / peak_b, 4)
        if peak_f and peak_b and c[1]:
            # machine balance: flops-per-byte the card can sustain;
            # programs below it are memory-bound on this card
            balance = peak_f / (peak_b * 1e9)
            row["bound"] = ("compute" if c[0] / c[1] >= balance
                            else "memory")
        rows.append(row)
    rows.sort(key=lambda r: -r["wall_s"])
    return rows


def snapshot() -> Dict[str, Any]:
    """The ``"roofline"`` document attached to /metrics/snapshot."""
    peak_f, peak_b = peaks()
    rows = roofline_table()
    wall = sum(r["wall_s"] for r in rows)
    flops = sum(r["flops_per_call"] * r["calls"] for r in rows)
    nbytes = sum(r["bytes_per_call"] * r["calls"] for r in rows)
    out: Dict[str, Any] = {
        "device": _device_kind(),
        "peak_tflops": round(peak_f / 1e12, 1) if peak_f else None,
        "peak_gbps": round(peak_b, 1) if peak_b else None,
        "samples": len(_window),
        "wall_s": round(wall, 6),
        "hbm_bw_gbps": (round(nbytes / wall / 1e9, 3)
                        if wall > 0 else 0.0),
        "programs": rows,
    }
    if wall > 0 and peak_f and flops:
        out["mfu"] = round(flops / wall / peak_f, 4)
    if wall > 0 and peak_b and nbytes:
        out["bw_util"] = round(nbytes / wall / 1e9 / peak_b, 4)
    return out


def reset():
    """Clear samples and cached instruments — test isolation (wired
    into ``obs.reset()``)."""
    global _ins
    with _lock:
        _window.clear()
        _totals.clear()
        _ins = None


__all__ = [
    "PEAK_SPECS", "WINDOW", "observe", "peaks", "reset",
    "roofline_table", "snapshot",
]

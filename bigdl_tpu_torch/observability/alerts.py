"""Declarative alert engine over the time-series store — the port of
``bigdl_tpu/observability/alerts.py``.

Rules are plain dicts evaluated on every store sample (the engine
rides :attr:`TimeSeriesStore.on_sample` — one injectable clock, no
second thread). Four kinds:

- ``threshold`` — ``{"name", "kind": "threshold", "series", "fn",
  "window", "op": ">"|">="|"<"|"<=", "value", "for": seconds}``: a
  window query compared against a bound, optionally held ``for``
  seconds (pending) before firing;
- ``absence`` — ``{"kind": "absence", "series", "window"}``: fires
  when the store HAS samples in the window but none carries the
  series (a scrape hole is not an absence — no data means inactive,
  never firing);
- ``burn_rate`` — ``{"kind": "burn_rate", "slo", "short", "long",
  "factor", "objective"?}``: the SRE-workbook multi-window
  multi-burn-rate condition over ``bigdl_slo_requests_total``. Burn =
  (violated/total in window) / error budget, budget = 1 − objective
  (``bigdl.slo.objective``, default 0.99). Fires only when BOTH the
  short and the long window burn exceed ``factor`` — the short window
  gives fast detection, the long window stops one bad scrape from
  paging;
- ``record`` — ``{"kind": "record", "series", "fn", "window"}``: a
  recording rule; the windowed value is republished every evaluation
  as ``bigdl_alerts_recorded{rule=<name>}``.

The built-in rule set is the workbook's first two pages per SLO
dimension (ttft, itl): fast-burn 5m/1h × 14.4 and slow-burn 1h/6h ×
6.0 — at those factors the fast rule pages after ~2% of a 30-day
budget burns in an hour. ``bigdl.observability.alerts.rules`` (JSON
list) replaces the set declaratively (a run of seconds sets tiny
windows through exactly that path).

State machine per rule: inactive → pending → firing → resolved, on
the store's clock. Entering ``firing`` / leaving it increment
``bigdl_alerts_transitions_total{rule,state}`` AND emit flight
``alert_fire`` / ``alert_resolve`` events at the same call site, so
alert counters and ``/debug/flight`` timelines reconcile exactly.
``bigdl_alerts_firing`` gauges the currently-firing count and
``GET /alerts`` serves the full rule table on the worker and the
router. The rule format, the state machine and the ``/alerts`` body
are the JAX package's.

Shares the ``bigdl.observability.timeseries.enabled`` gate (this
module is only ever constructed by ``timeseries.acquire()``): disabled
means no engine, no ``bigdl_alerts_*`` series, ``/alerts`` 404.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Any, Dict, List, Optional

from bigdl_tpu_torch.utils.conf import conf
from bigdl_tpu_torch.observability import flight

_lock = threading.Lock()
_engine: Optional["AlertEngine"] = None
_ins: Optional[Dict[str, Any]] = None

#: (short_s, long_s, factor) — SRE workbook table, 30-day budget.
FAST_BURN = (300.0, 3600.0, 14.4)
SLOW_BURN = (3600.0, 21600.0, 6.0)

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


def default_rules() -> List[dict]:
    """The built-in multi-window burn-rate set over
    ``bigdl_slo_requests_total``."""
    rules = []
    for slo in ("ttft", "itl"):
        for tag, (short, long_, factor) in (("fast", FAST_BURN),
                                            ("slow", SLOW_BURN)):
            rules.append({
                "name": f"slo-{tag}-burn-{slo}", "kind": "burn_rate",
                "slo": slo, "short": short, "long": long_,
                "factor": factor,
            })
    return rules


def load_rules() -> List[dict]:
    """The active rule set: ``bigdl.observability.alerts.rules`` (JSON
    list of rule dicts) when set, the built-ins otherwise. A broken
    override falls back to the built-ins — a config typo must not
    silence the SLO pages."""
    raw = (conf.get("bigdl.observability.alerts.rules", "") or "").strip()
    if not raw:
        return default_rules()
    try:
        rules = json.loads(raw)
        if not isinstance(rules, list):
            raise ValueError("rules must be a JSON list")
        for i, r in enumerate(rules):
            if not isinstance(r, dict) or not r.get("name"):
                raise ValueError(f"rule {i} needs a name")
        return rules
    except (ValueError, TypeError):
        return default_rules()


def _instruments() -> Optional[Dict[str, Any]]:
    global _ins
    from bigdl_tpu_torch import observability as obs
    if not obs.enabled():
        return None
    if _ins is None:
        _ins = {
            "firing": obs.gauge(
                "bigdl_alerts_firing",
                "Alert rules currently in the firing state"),
            "transitions": obs.counter(
                "bigdl_alerts_transitions_total",
                "Alert state-machine transitions by rule and new state",
                labelnames=("rule", "state")),
            "recorded": obs.gauge(
                "bigdl_alerts_recorded",
                "Recording-rule outputs, one series per rule",
                labelnames=("rule",)),
        }
    return _ins


class AlertEngine:
    """Evaluates the rule set against one
    :class:`~bigdl_tpu_torch.observability.timeseries.TimeSeriesStore` on its
    sample clock."""

    def __init__(self, store, rules: Optional[List[dict]] = None):
        self.store = store
        self.rules = rules if rules is not None else load_rules()
        self._lock = threading.Lock()
        self._states: Dict[str, Dict[str, Any]] = {}
        self.evaluations = 0
        self.transitions = 0

    def _state(self, name: str) -> Dict[str, Any]:
        return self._states.setdefault(name, {
            "state": "inactive", "since": None, "value": None,
            "pending_since": None, "last_fired": None,
            "last_resolved": None, "fired_count": 0,
        })

    # -- rule conditions -----------------------------------------------------
    def _burn(self, slo: str, window: float, objective: float,
              now: float) -> float:
        """Burn rate for one window: violation ratio over the error
        budget. NaN when the window has no classified requests."""
        labels = {"slo": slo, "verdict": "violated"}
        bad = self.store.query("bigdl_slo_requests_total", "delta",
                               window, labels=labels, now=now)
        labels = {"slo": slo, "verdict": "ok"}
        ok = self.store.query("bigdl_slo_requests_total", "delta",
                              window, labels=labels, now=now)
        bad = 0.0 if math.isnan(bad) else bad
        ok = 0.0 if math.isnan(ok) else ok
        total = bad + ok
        if total <= 0:
            return float("nan")
        budget = max(1.0 - objective, 1e-9)
        return (bad / total) / budget

    def _eval_condition(self, rule: dict, now: float):
        """``(active, value, detail)`` for one rule at ``now``."""
        kind = rule.get("kind", "threshold")
        if kind == "burn_rate":
            objective = float(rule.get("objective") or conf.get_float(
                "bigdl.slo.objective", 0.99))
            factor = float(rule.get("factor", FAST_BURN[2]))
            short = self._burn(rule["slo"], float(rule["short"]),
                               objective, now)
            long_ = self._burn(rule["slo"], float(rule["long"]),
                               objective, now)
            active = (not math.isnan(short) and not math.isnan(long_)
                      and short > factor and long_ > factor)
            return active, short, {"short_burn": short,
                                   "long_burn": long_,
                                   "factor": factor}
        series = rule.get("series", "")
        from bigdl_tpu_torch.observability.timeseries import parse_series
        name, labels = parse_series(series)
        labels.update(rule.get("labels") or {})
        window = float(rule.get("window", 300.0))
        instance = rule.get("instance")
        if kind == "absence":
            # a window with no store samples at all is a scrape hole,
            # not an absence: stay inactive rather than page on it
            if not self.store._window(window, now):
                return False, None, {"samples": 0}
            pts = self.store.points(name, labels or None, instance,
                                    window, now)
            return (not pts), float(len(pts)), {"points": len(pts)}
        value = self.store.query(name, fn=rule.get("fn", "last"),
                                 window=window, labels=labels or None,
                                 instance=instance, now=now)
        if kind == "record":
            return False, value, {"recorded": True}
        op = _OPS.get(rule.get("op", ">"))
        bound = float(rule.get("value", 0.0))
        active = (op is not None and not math.isnan(value)
                  and op(value, bound))
        return active, value, {"op": rule.get("op", ">"), "bound": bound}

    # -- the state machine ---------------------------------------------------
    def _transition(self, name: str, st: Dict[str, Any], new: str,
                    now: float, value, detail: dict):
        st["state"] = new
        st["since"] = now
        self.transitions += 1
        ins = _instruments()
        if ins is not None:
            ins["transitions"].labels(rule=name, state=new).inc()
        if new == "firing":
            st["last_fired"] = now
            st["fired_count"] += 1
            flight.record("alert_fire", rule=name,
                          value=_jsonable(value), **detail)
        elif new == "resolved":
            st["last_resolved"] = now
            flight.record("alert_resolve", rule=name,
                          value=_jsonable(value), **detail)

    def evaluate(self, now: float):
        """One pass over every rule (the store's ``on_sample`` hook)."""
        ins = _instruments()
        with self._lock:
            self.evaluations += 1
            for rule in self.rules:
                name = rule.get("name", "?")
                try:
                    active, value, detail = self._eval_condition(
                        rule, now)
                except Exception:   # noqa: BLE001 — one bad rule must
                    continue        # not starve the rest
                st = self._state(name)
                st["value"] = _jsonable(value)
                if rule.get("kind") == "record":
                    if ins is not None and value is not None \
                            and not math.isnan(value):
                        ins["recorded"].labels(rule=name).set(value)
                    st["state"] = "recording"
                    continue
                for_s = float(rule.get("for", 0.0))
                cur = st["state"]
                if active:
                    if cur in ("inactive", "resolved"):
                        if for_s > 0:
                            st["pending_since"] = now
                            self._transition(name, st, "pending", now,
                                             value, detail)
                        else:
                            self._transition(name, st, "firing", now,
                                             value, detail)
                    elif cur == "pending" and st["pending_since"] \
                            is not None and \
                            now - st["pending_since"] >= for_s:
                        self._transition(name, st, "firing", now,
                                         value, detail)
                else:
                    if cur == "firing":
                        self._transition(name, st, "resolved", now,
                                         value, detail)
                    elif cur == "pending":
                        st["pending_since"] = None
                        self._transition(name, st, "inactive", now,
                                         value, detail)
            firing = sum(1 for s in self._states.values()
                         if s["state"] == "firing")
        if ins is not None:
            ins["firing"].set(firing)

    # -- views ---------------------------------------------------------------
    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._states.items()
                          if s["state"] == "firing")

    def status(self) -> dict:
        """The ``GET /alerts`` body."""
        with self._lock:
            rules = []
            for rule in self.rules:
                name = rule.get("name", "?")
                st = self._states.get(name) or {"state": "inactive"}
                rules.append({**{k: v for k, v in rule.items()},
                              **{k: st.get(k) for k in
                                 ("state", "since", "value",
                                  "last_fired", "last_resolved",
                                  "fired_count")}})
            firing = sorted(n for n, s in self._states.items()
                            if s["state"] == "firing")
            return {"rules": rules, "firing": firing,
                    "evaluations": self.evaluations,
                    "transitions": self.transitions}


def _jsonable(v):
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def engine() -> Optional[AlertEngine]:
    """The live engine, or None when the plane never started (the
    structural-absence invariant)."""
    return _engine


def ensure_engine(store) -> AlertEngine:
    """Build the engine for ``store`` and hook it onto the sample tick
    (idempotent; called from ``timeseries.acquire()``)."""
    global _engine
    with _lock:
        if _engine is None or _engine.store is not store:
            _engine = AlertEngine(store)
        eng = _engine
    if eng.evaluate not in store.on_sample:
        store.on_sample.append(eng.evaluate)
    return eng


def reset():
    """Drop the engine and cached instruments — test isolation (wired
    into ``obs.reset()``)."""
    global _engine, _ins
    with _lock:
        _engine = None
        _ins = None


def debug_endpoint(path: str):
    """Serve ``GET /alerts`` for any HTTP handler — ``(status,
    jsonable)`` including the 404 arm when the plane is disabled, or
    ``None`` for paths this module does not own."""
    from urllib.parse import urlsplit
    from bigdl_tpu_torch.observability import timeseries
    if urlsplit(path).path != "/alerts":
        return None
    if not timeseries.enabled:
        return 404, {"error": "timeseries disabled",
                     "gate": "bigdl.observability.timeseries.enabled"}
    eng = _engine
    if eng is None:
        return 200, {"rules": [{**r, "state": "inactive"}
                               for r in load_rules()],
                     "firing": [], "evaluations": 0, "transitions": 0}
    return 200, eng.status()


__all__ = [
    "AlertEngine", "FAST_BURN", "SLOW_BURN", "debug_endpoint",
    "default_rules", "engine", "ensure_engine", "load_rules", "reset",
]

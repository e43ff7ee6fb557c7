"""Per-request SLO accounting — the port of
``bigdl_tpu/observability/slo.py``.

The two latency objectives serving PRs are judged on (ROADMAP item 4,
and the Ragged-Paged-Attention evaluation metrics): **TTFT** — time
from admission to the first token — and **ITL** — the gap between
consecutive tokens. :class:`SLOAccount` is the shared recorder both
sides of the stack instantiate when ``bigdl.slo.enabled`` is on:

- the **engine** (:class:`~bigdl_tpu_torch.llm.serving.LLMServer`) records
  TTFT at the first drained token and one ITL sample per subsequent
  token, into ``bigdl_llm_{ttft,itl}_seconds`` quantile sketches;
- the **router** (the JAX package's ``LLMRouter`` in failover mode;
  the port's router is ROADMAP Queue 1 item 8) records the *client-visible* equivalents from the journal's
  streamed-token arrival timestamps into
  ``bigdl_router_{ttft,itl}_seconds`` — resumed and hedged tokens are
  stamped exactly once (the journal's longest-prefix-wins ``drained``
  only stamps indices it actually extends), so a mid-stream failover
  contributes its real recovery gap as ONE honest ITL sample instead
  of double-counting replayed tokens.

Each finished request is classified against ``bigdl.slo.ttft_ms`` /
``bigdl.slo.itl_ms`` (ITL verdict = the request's *worst* gap) into
``bigdl_slo_requests_total{slo,verdict,scope}``, and a rolling burn
rate is exported as ``bigdl_slo_burn_rate{slo,scope}`` and surfaced
in the ``/healthz`` bodies, so a prober or autoscaler reads one
number instead of differencing counters. The burn is over the last
``bigdl.slo.window`` requests: the JAX package's behaviour while its
time-series plane is off (the port has no such plane yet).

Structural absence: with ``bigdl.slo.enabled=false`` (the default)
:meth:`SLOAccount.if_enabled` returns ``None`` — no sketch series, no
``bigdl_slo_*`` series, no window deques, nothing in ``/healthz``.
Instruments are declared lazily on first record so an enabled account
under a disabled observability switch still mints zero series.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional

from bigdl_tpu_torch import observability as obs

#: SLO dimensions and their counter/gauge label value.
TTFT, ITL = "ttft", "itl"


class SLOAccount:
    """TTFT/ITL sketches + threshold classification + rolling burn rate
    for one scope (``engine`` or ``router``)."""

    def __init__(self, scope: str,
                 ttft_ms: Optional[float] = None,
                 itl_ms: Optional[float] = None,
                 window: Optional[int] = None):
        from bigdl_tpu_torch.utils.conf import conf
        if scope not in ("engine", "router"):
            raise ValueError(f"unknown SLO scope {scope!r}")
        self.scope = scope
        self.ttft_s = (ttft_ms if ttft_ms is not None else
                       conf.get_float("bigdl.slo.ttft_ms", 500.0)) / 1000.0
        self.itl_s = (itl_ms if itl_ms is not None else
                      conf.get_float("bigdl.slo.itl_ms", 200.0)) / 1000.0
        win = (window if window is not None else
               conf.get_int("bigdl.slo.window", 100))
        self._lock = threading.Lock()
        self._window: Dict[str, collections.deque] = {
            TTFT: collections.deque(maxlen=max(int(win), 1)),
            ITL: collections.deque(maxlen=max(int(win), 1))}
        self.requests = 0
        self.violations = {TTFT: 0, ITL: 0}
        self._ins = None

    @classmethod
    def if_enabled(cls, scope: str, enabled: Optional[bool] = None
                   ) -> Optional["SLOAccount"]:
        """The construction gate every caller uses: ``None`` (and
        therefore structural absence) unless ``bigdl.slo.enabled`` —
        or the explicit ``enabled`` ctor override — says on."""
        from bigdl_tpu_torch.utils.conf import conf
        on = (enabled if enabled is not None else
              conf.get_bool("bigdl.slo.enabled", False))
        return cls(scope) if on else None

    # -- instruments ---------------------------------------------------------
    def _instruments(self):
        if not obs.enabled():
            return None
        if self._ins is None:
            if self.scope == "engine":
                ttft = obs.sketch(
                    "bigdl_llm_ttft_seconds",
                    "Engine time to first token (submit to first "
                    "drained token), mergeable quantile sketch")
                itl = obs.sketch(
                    "bigdl_llm_itl_seconds",
                    "Engine gap between consecutive drained tokens of "
                    "one request, mergeable quantile sketch")
            else:
                ttft = obs.sketch(
                    "bigdl_router_ttft_seconds",
                    "Client-visible time to first streamed token at "
                    "the router, mergeable quantile sketch")
                itl = obs.sketch(
                    "bigdl_router_itl_seconds",
                    "Client-visible gap between streamed tokens at "
                    "the router (resumed/hedged tokens stamped once), "
                    "mergeable quantile sketch")
            self._ins = {
                "ttft": ttft,
                "itl": itl,
                "requests": obs.counter(
                    "bigdl_slo_requests_total",
                    "Finished requests classified against the "
                    "bigdl.slo.* thresholds",
                    labelnames=("slo", "verdict", "scope")),
                "burn": obs.gauge(
                    "bigdl_slo_burn_rate",
                    "Fraction of the last bigdl.slo.window requests "
                    "violating the SLO",
                    labelnames=("slo", "scope")),
            }
        return self._ins

    # -- sample recording ----------------------------------------------------
    def observe_ttft(self, seconds: float):
        ins = self._instruments()
        if ins is not None:
            ins["ttft"].observe(seconds)

    def observe_itl(self, seconds: float):
        ins = self._instruments()
        if ins is not None:
            ins["itl"].observe(seconds)

    # -- per-request classification ------------------------------------------
    def finish(self, ttft_s: Optional[float],
               itl_max_s: Optional[float]):
        """Classify one finished request. ``None`` ttft (the request
        never produced a token) counts as a TTFT violation; ``None``
        itl_max (a single-token answer has no gaps) is vacuously
        compliant."""
        verdicts = {
            TTFT: (ttft_s is not None and ttft_s <= self.ttft_s),
            ITL: (itl_max_s is None or itl_max_s <= self.itl_s)}
        with self._lock:
            self.requests += 1
            for slo, ok in verdicts.items():
                if not ok:
                    self.violations[slo] += 1
                self._window[slo].append(0 if ok else 1)
            burns = {slo: (sum(w) / len(w) if w else 0.0)
                     for slo, w in self._window.items()}
        ins = self._instruments()
        if ins is not None:
            for slo, ok in verdicts.items():
                ins["requests"].labels(
                    slo=slo, verdict=("ok" if ok else "violated"),
                    scope=self.scope).inc()
                ins["burn"].labels(slo=slo, scope=self.scope).set(
                    burns[slo])

    def burn_rates(self) -> Dict[str, float]:
        with self._lock:
            return {slo: (sum(w) / len(w) if w else 0.0)
                    for slo, w in self._window.items()}

    def status(self) -> dict:
        """The ``/healthz`` block."""
        with self._lock:
            burns = {slo: (sum(w) / len(w) if w else 0.0)
                     for slo, w in self._window.items()}
            return {
                "scope": self.scope,
                "ttft_ms": self.ttft_s * 1000.0,
                "itl_ms": self.itl_s * 1000.0,
                "requests": self.requests,
                "violations": dict(self.violations),
                "burn_rate": burns,
            }


def itl_samples(token_times: List[float]) -> List[float]:
    """Inter-token gaps from a request's token arrival stamps (the
    router side's journal timestamps)."""
    return [b - a for a, b in zip(token_times, token_times[1:])]

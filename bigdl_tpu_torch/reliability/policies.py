"""Policy primitives — the port of ``bigdl_tpu/reliability/policies.py``.

The building blocks the serving paths compose:

- :class:`RetryPolicy` — exponential backoff with seeded jitter and an
  attempt budget; injectable clock/sleep so tests never sleep;
- :class:`Deadline` — a monotonic-clock budget propagated per-request
  (HTTP header ``X-BigDL-Deadline-Ms``);
- :class:`CircuitBreaker` — closed → open after N consecutive failures,
  half-open probe after ``reset_timeout``, with every transition
  counted (``bigdl_reliability_breaker_transitions_total``);
- health-check registry — named liveness callables rendered by
  ``GET /healthz`` on the worker;
- :func:`retry_after_seconds` — the Retry-After of a 503 shed.

All knobs default from the layered config (``bigdl.reliability.retry.*``,
``bigdl.llm.retry_after.*``) so operators tune one place.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Iterator, Optional, Tuple


class DeadlineExceeded(TimeoutError):
    """A propagated per-request deadline ran out."""


class CircuitOpenError(RuntimeError):
    """The breaker is open: the call was rejected without being tried."""


class OverloadError(RuntimeError):
    """Admission control rejected new work (bounded queue full or the
    component is draining). HTTP surfaces map this to 503 + Retry-After."""


def _count(_metric: str, _help: str, **labels):
    # positional params are underscored: labels legitimately use keys
    # like ``name`` (breaker transitions), which must not collide.
    # Gated on the reliability switch too: a disabled process must mint
    # ZERO bigdl_reliability_* series (the structurally-absent contract)
    # even though the policy objects themselves keep working.
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.reliability import _state
    if not _state.enabled or not obs.enabled():
        return
    c = obs.counter(_metric, _help, labelnames=tuple(labels))
    (c.labels(**labels) if labels else c).inc()


# ---------------------------------------------------------------------------
# Deadline
# ---------------------------------------------------------------------------

#: Header carrying the remaining budget downstream, in integer ms.
DEADLINE_HEADER = "X-BigDL-Deadline-Ms"


class Deadline:
    """A fixed point on the monotonic clock. Cheap value object: callers
    pass it down the stack; every blocking wait takes
    ``min(its own timeout, deadline.remaining())``."""

    __slots__ = ("_at", "_clock")

    def __init__(self, seconds: float, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._at = clock() + float(seconds)

    def remaining(self) -> float:
        return self._at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0

    def check(self, what: str = "request"):
        """Raise :class:`DeadlineExceeded` (and count it) if expired."""
        if self.expired():
            _count("bigdl_reliability_deadline_expired_total",
                   "Deadlines that ran out before the work completed")
            raise DeadlineExceeded(f"deadline exceeded for {what}")

    def to_header(self) -> str:
        return str(max(int(self.remaining() * 1000), 0))

    @staticmethod
    def from_header(value: Optional[str],
                    clock: Callable[[], float] = time.monotonic
                    ) -> Optional["Deadline"]:
        """Parse a ``X-BigDL-Deadline-Ms`` header; None/garbage → None
        (an unparseable deadline must not fail the request)."""
        if not value:
            return None
        try:
            return Deadline(int(value) / 1000.0, clock=clock)
        except (TypeError, ValueError):
            return None


#: Process-wide RNG for Retry-After jitter. Module-level (not per-call)
#: so a shed storm decorrelates across requests within one process.
_RETRY_AFTER_RNG = random.Random()


def retry_after_seconds(queue_depth: int = 0,
                        rng: Optional[random.Random] = None) -> str:
    """Derive a ``Retry-After`` header value from observed queue depth.

    ``clamp(base + per_queued * depth, 1, max)`` stretched by up to
    ``jitter`` fraction so a thundering herd of shed clients does not
    retry in lockstep (at the cap the jitter spreads downward instead,
    so saturation never re-synchronizes the herd). All knobs under
    ``bigdl.llm.retry_after.*``.
    Returns the integer-second string HTTP wants; an empty queue with
    the default knobs still renders ``"1"`` (jitter stretches the value
    by at most 20% before rounding), so existing clients see no change
    until pressure actually builds."""
    from bigdl_tpu_torch.utils.conf import conf
    base = conf.get_float("bigdl.llm.retry_after.base", 1.0)
    per = conf.get_float("bigdl.llm.retry_after.per_queued", 0.25)
    cap = conf.get_float("bigdl.llm.retry_after.max", 30.0)
    jitter = conf.get_float("bigdl.llm.retry_after.jitter", 0.2)
    r = (rng or _RETRY_AFTER_RNG).random()
    val = base + per * max(int(queue_depth), 0)
    if val >= cap:
        # saturated: jitter DOWN from the cap — stretching upward and
        # clamping would hand every shed client exactly the cap,
        # re-synchronizing the herd precisely at the deepest backlog
        val = cap * (1.0 - max(jitter, 0.0) * r)
    else:
        val = min(val * (1.0 + max(jitter, 0.0) * r), cap)
    return str(max(1, int(round(val))))


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

class RetryPolicy:
    """Exponential backoff + seeded jitter + attempt budget.

    ``max_attempts`` counts *tries*, not retries: 3 means one initial
    attempt and up to two retries. Delay before retry ``i`` (0-based) is
    ``min(max_delay, base_delay * multiplier**i)`` stretched by up to
    ``jitter`` fraction via the policy's own seeded RNG — deterministic
    schedules for tests, decorrelated fleets in production (every
    process seeds from entropy by default).

    ``clock``/``sleep`` are injectable so the tier-1 suite exercises
    full schedules with a fake clock and zero real sleeping.
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 base_delay: Optional[float] = None,
                 max_delay: Optional[float] = None,
                 multiplier: float = 2.0, jitter: float = 0.5,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        from bigdl_tpu_torch.utils.conf import conf
        self.max_attempts = max_attempts if max_attempts is not None else \
            (conf.get_int("bigdl.reliability.retry.max.attempts", 3) or 3)
        self.base_delay = base_delay if base_delay is not None else \
            conf.get_float("bigdl.reliability.retry.base.delay", 0.05)
        self.max_delay = max_delay if max_delay is not None else \
            conf.get_float("bigdl.reliability.retry.max.delay", 2.0)
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delays(self) -> Iterator[float]:
        """The backoff schedule: ``max_attempts - 1`` delays."""
        for i in range(max(self.max_attempts - 1, 0)):
            base = min(self.max_delay,
                       self.base_delay * self.multiplier ** i)
            yield base * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable, *args,
             retry_on: Tuple = (Exception,),
             deadline: Optional[Deadline] = None,
             on_retry: Optional[Callable] = None,
             component: str = "", **kwargs):
        """Run ``fn`` under the policy. ``on_retry(exc, attempt)`` is
        called before each backoff sleep; ``component`` labels the
        ``bigdl_reliability_retries_total`` increments."""
        delays = self.delays()
        attempt = 0
        while True:
            if deadline is not None:
                deadline.check(component or "retryable call")
            try:
                return fn(*args, **kwargs)
            except retry_on as e:
                attempt += 1
                try:
                    delay = next(delays)
                except StopIteration:
                    raise e
                _count("bigdl_reliability_retries_total",
                       "Retries performed under a RetryPolicy",
                       component=component or "unknown")
                if on_retry is not None:
                    on_retry(e, attempt)
                if deadline is not None and \
                        delay >= max(deadline.remaining(), 0):
                    raise e    # sleeping would blow the deadline anyway
                self._sleep(delay)


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Classic three-state breaker.

    closed --(``failure_threshold`` consecutive failures)--> open
    open --(``reset_timeout`` on the clock)--> half_open (one probe)
    half_open --success--> closed; --failure--> open (timer restarts)

    Thread-safe; ``clock`` injectable for sleep-free tests. Transitions
    increment ``bigdl_reliability_breaker_transitions_total{name,state}``
    so an operator can watch a trip and its recovery on /metrics.
    """

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._probe_locked()

    def _probe_locked(self) -> str:
        if self._state == "open" and \
                self._clock() - self._opened_at >= self.reset_timeout:
            self._transition("half_open")
        return self._state

    def _transition(self, new: str):
        if new != self._state:
            self._state = new
            _count("bigdl_reliability_breaker_transitions_total",
                   "CircuitBreaker state transitions",
                   name=self.name, state=new)

    def allow(self) -> bool:
        """May a call proceed right now? (open → False; the half-open
        probe slot is granted to the first caller after the timeout)."""
        with self._lock:
            return self._probe_locked() != "open"

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._transition("closed")

    def record_failure(self):
        with self._lock:
            self._failures += 1
            if self._state == "half_open" or \
                    self._failures >= self.failure_threshold:
                self._opened_at = self._clock()
                self._transition("open")

    def call(self, fn: Callable, *args, **kwargs):
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.name!r} is open (retry after "
                f"{self.reset_timeout:g}s)")
        try:
            out = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out


# ---------------------------------------------------------------------------
# Health checks
# ---------------------------------------------------------------------------

_health_lock = threading.Lock()
_health_checks: Dict[str, Callable[[], object]] = {}


def register_health(name: str, fn: Callable[[], object]):
    """Register a liveness callable. It should return quickly: truthy /
    a detail dict means healthy; raising or returning falsy means not.
    No-op when the reliability layer is disabled (the disabled-mode test
    asserts an empty registry)."""
    from bigdl_tpu_torch.reliability import _state
    if not _state.enabled:
        return
    with _health_lock:
        _health_checks[name] = fn


def unregister_health(name: str):
    with _health_lock:
        _health_checks.pop(name, None)


def health_checks() -> Dict[str, Callable]:
    with _health_lock:
        return dict(_health_checks)


def health_report() -> Tuple[bool, Dict[str, dict]]:
    """Run every registered check. Returns (all_ok, per-check detail) —
    the body ``GET /healthz`` serves with 200/503."""
    report: Dict[str, dict] = {}
    ok = True
    for name, fn in sorted(health_checks().items()):
        try:
            out = fn()
            healthy = bool(out) if not isinstance(out, dict) else \
                bool(out.get("ok", True))
            detail = out if isinstance(out, dict) else {}
            report[name] = {"ok": healthy, **detail}
        except Exception as e:  # noqa: BLE001 — a check must never 500
            healthy = False
            report[name] = {"ok": False, "error": repr(e)}
        ok = ok and healthy
    return ok, report

"""Request-level failover primitives — the port of
``bigdl_tpu/llm/failover.py``: the pieces :class:`~bigdl_tpu_torch.llm.
worker.LLMRouter` composes when ``bigdl.llm.failover.enabled`` (or
``bigdl.llm.hedge.enabled``) is on, and :class:`StreamAbort`, which the
single-node worker and the OpenAI gateway raise.

- :class:`RequestJournal` — the in-flight ledger: each routed request's
  prompt plus every token drained so far. On a decode-backend failure
  the router re-dispatches ``prompt + generated_so_far`` to another
  backend; greedy decoding is deterministic, so the resumed suffix is
  the tokens the dead worker would have produced (bit for bit on the
  CPU in f32; on the card the resumed suffix is prefilled where the
  dead worker decoded it, so bf16 sums may part), and the radix cache
  or the host tier turn the resume into a short suffix prefill.
- :class:`HealthProber` — a background thread polling each backend's
  ``/healthz`` so ``_pick`` routes on *observed* health (a watchdog-
  tripped worker answers 503 and leaves the pool before a request has
  to die on it), and pool membership can change without a restart.
- :class:`LatencyTracker` / :class:`HedgePolicy` — the p95 estimator
  and the hedge budget behind hedged dispatch: a prefill or decode call
  slower than the stage's observed p95 is duplicated to a second
  backend, first success wins, the loser is cancelled
  (:class:`Canceller` closes its connection; the worker aborts the
  request and frees its KV pages).
- :func:`run_hedged` — the generic first-success-wins runner.

Everything here is host-side plumbing over HTTP and host state: no
tensor, no engine state, no device call. With failover and hedging off
none of it is constructed (the structurally-absent contract the
disabled-mode tests assert). Calls, snapshots, quantiles, hedge
decisions and winners are the JAX module's.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Request journal
# ---------------------------------------------------------------------------

class StreamAbort(Exception):
    """Raised *through* a decode stream to tear it down without a
    failover retry: the OpenAI gateway raises it when the SSE client
    hung up (``client_gone=True`` — the request is aborted, its slot and
    KV pages free) or when a ``stop`` sequence is satisfied mid-stream
    (the answer is complete; the rest of the token budget would be
    wasted work). Never a breaker failure and never a failover attempt
    — the backend did nothing wrong."""

    def __init__(self, reason: str, client_gone: bool = False):
        super().__init__(reason)
        self.client_gone = client_gone


class JournalEntry:
    """One in-flight routed request: the resume state failover needs."""

    __slots__ = ("id", "prompt_ids", "max_new_tokens", "tokens",
                 "attempts", "hedges", "created_at", "finish_reason",
                 "token_times", "priority", "listener")

    def __init__(self, entry_id: int, prompt_ids: List[int],
                 max_new_tokens: int, priority: Optional[str] = None):
        self.id = entry_id
        self.prompt_ids = list(prompt_ids)
        self.max_new_tokens = int(max_new_tokens)
        # SLO class as received on the wire; None when the
        # client sent no X-BigDL-Priority header — the journal never
        # normalizes, the engine does
        self.priority = priority
        self.tokens: List[int] = []       # drained so far (all attempts)
        self.attempts = 0                 # decode dispatches issued
        self.hedges = 0
        self.created_at = time.monotonic()
        self.finish_reason: Optional[str] = None
        # client-visible arrival stamp per token (SLO
        # accounting): aligned with ``tokens``, written by ``drained``
        # only for the indices an update actually extends — so a
        # resume's replayed prefix and a hedge twin's echo never
        # re-stamp a token, and the failover recovery gap shows up as
        # one honest inter-token sample
        self.token_times: List[float] = []
        # journal→SSE relay: an optional callable fired
        # from ``drained`` with exactly the newly-extended token slice.
        # Because it sits INSIDE the exactly-once growth guard, the
        # gateway's SSE chunks and the SLO arrival stamps are the same
        # accounting — a hedge twin's echo or a resume's replayed
        # prefix can no more double-emit a chunk than double-stamp a
        # token. May raise :class:`StreamAbort` to tear down the
        # attempt (client disconnect / stop satisfied).
        self.listener: Optional[Callable[[List[int]], None]] = None

    @property
    def remaining(self) -> int:
        return max(self.max_new_tokens - len(self.tokens), 0)

    def resume_prompt(self) -> List[int]:
        """What a re-dispatch sends: the original prompt plus every
        token already delivered — the radix cache on the new backend
        sees it as one long cached prefix."""
        return self.prompt_ids + self.tokens

    def drained(self, cumulative: List[int], base: int = 0):
        """Record a stream chunk's CUMULATIVE token list for the
        attempt that started at ``base`` tokens. Idempotent: stream
        chunks repeat everything drained so far, so shorter/equal
        updates (a hedge twin behind the winner) are no-ops — a plain
        ``extend`` here would duplicate tokens and corrupt
        :meth:`resume_prompt` on the next failover (and double-stamp
        ITL samples)."""
        if base + len(cumulative) > len(self.tokens):
            # the guard means tokens only ever GROW, so stamping the
            # tail up to the new length covers exactly the indices
            # this update added
            prev = len(self.tokens)
            self.tokens[base:] = [int(t) for t in cumulative]
            now = time.monotonic()
            while len(self.token_times) < len(self.tokens):
                self.token_times.append(now)
            if self.listener is not None:
                # one relay call per drained token group;
                # the slice is exactly what this update added
                self.listener(self.tokens[prev:])


class RequestJournal:
    """Thread-safe ledger of in-flight routed requests. The router adds
    an entry at admission, updates it as tokens drain, and removes it on
    completion — ``inflight()`` is what ``/healthz`` and the journal
    gauge report. Only constructed when failover is enabled."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._entries: Dict[int, JournalEntry] = {}
        self.completed = 0
        self.failovers = 0                # re-dispatches after failure
        self.tokens_resumed = 0           # tokens carried across them

    def add(self, prompt_ids, max_new_tokens: int,
            priority: Optional[str] = None) -> JournalEntry:
        ent = JournalEntry(next(self._ids), prompt_ids, max_new_tokens,
                           priority=priority)
        with self._lock:
            self._entries[ent.id] = ent
        return ent

    def record_failover(self, ent: JournalEntry):
        with self._lock:
            self.failovers += 1
            self.tokens_resumed += len(ent.tokens)
        # same site as the ledger: the flight cross-check asserts
        # failover events reconcile exactly with the router counter
        # (trace id picked up from the routing thread's ambient context)
        from bigdl_tpu_torch.observability import flight
        flight.record("failover", entry=ent.id,
                      tokens_resumed=len(ent.tokens),
                      attempt=ent.attempts)

    def complete(self, ent: JournalEntry):
        with self._lock:
            self._entries.pop(ent.id, None)
            self.completed += 1

    def inflight(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(
                {"id": e.id, "prompt_tokens": len(e.prompt_ids),
                 "tokens_drained": len(e.tokens),
                 "attempts": e.attempts, "hedges": e.hedges,
                 "age_s": round(time.monotonic() - e.created_at, 3)},
                **({"priority": e.priority}
                   if e.priority is not None else {}))
                    for e in self._entries.values()]


# ---------------------------------------------------------------------------
# Active health model
# ---------------------------------------------------------------------------

class HealthProber:
    """Background ``/healthz`` poller feeding live pool membership.

    ``targets_fn`` returns the current ``[(addr, role), ...]`` snapshot
    (pools are mutable via the router's admin endpoint, so the prober
    re-reads them every sweep). A backend is healthy until a probe says
    otherwise — a freshly added backend is immediately routable, and a
    worker whose watchdog tripped (``/healthz`` 503) leaves the pool
    within one interval instead of eating a live request first.
    ``on_probe(addr, role, healthy, body)`` is the router's gauge hook.
    """

    def __init__(self, targets_fn: Callable[[], List[Tuple[Any, str]]],
                 interval: float = 0.5, timeout: float = 2.0,
                 on_probe: Optional[Callable] = None):
        self._targets_fn = targets_fn
        self.interval = interval
        self.timeout = timeout
        self._on_probe = on_probe
        self._lock = threading.Lock()
        self._status: Dict[Any, bool] = {}
        # last observed healthz verdict string:
        # DRAINING is not DEAD — a draining backend finishes its
        # in-flight streams and must never trip a breaker or trigger
        # failover; it just takes no new work. "dead" = the probe
        # itself failed (connection refused / timeout).
        self._states: Dict[Any, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.probes = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "HealthProber":
        self._thread = threading.Thread(target=self._loop,
                                        name="bigdl-router-prober",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout + 1.0)

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.probe_now()
            except Exception:   # noqa: BLE001 — the prober never dies
                pass

    # -- probing -------------------------------------------------------------
    def _probe_one(self, addr) -> Tuple[bool, dict]:
        import http.client
        import json
        conn = http.client.HTTPConnection(addr[0], addr[1],
                                          timeout=self.timeout)
        try:
            conn.request("GET", "/healthz")
            resp = conn.getresponse()
            raw = resp.read()
            try:
                body = json.loads(raw.decode())
            except ValueError:
                body = {}
            return resp.status == 200, body
        finally:
            conn.close()

    def probe_now(self):
        """One synchronous sweep over the current targets (also the
        tests' fake clock: no sleeping on the poll interval)."""
        for addr, role in list(self._targets_fn()):
            if self._stop.is_set():
                return
            try:
                healthy, body = self._probe_one(addr)
                state = str(body.get("status") or
                            ("ok" if healthy else "unhealthy"))
            except Exception:   # noqa: BLE001 — dead = unhealthy
                healthy, body, state = False, {}, "dead"
            with self._lock:
                self._status[addr] = healthy
                self._states[addr] = state
            self.probes += 1
            if self._on_probe is not None:
                try:
                    self._on_probe(addr, role, healthy, body)
                except Exception:   # noqa: BLE001
                    pass

    def healthy(self, addr) -> bool:
        """Unprobed backends default healthy: a just-added backend must
        be routable before the first sweep reaches it."""
        with self._lock:
            return self._status.get(addr, True)

    def state(self, addr) -> str:
        """Last observed verdict: ``"ok"`` / ``"draining"`` /
        ``"stalled"`` / ``"unhealthy"`` / ``"dead"`` (unprobed backends
        are ``"ok"`` — same default as :meth:`healthy`). The router's
        drain handling branches on this: DRAINING backends finish
        their in-flight work and are simply not picked; only the other
        non-ok states mean failover-now."""
        with self._lock:
            return self._states.get(
                addr, "ok" if self._status.get(addr, True)
                else "unhealthy")

    def mark(self, addr, state: str):
        """Out-of-band verdict between sweeps: the router
        marks a backend ``"draining"`` the moment it sees the drain
        503 (or initiates the drain itself) instead of waiting an
        interval for the next probe; ``"ok"`` puts an
        abandoned-drain backend straight back into rotation. The next
        real probe overwrites either."""
        with self._lock:
            self._states[addr] = state
            self._status[addr] = state == "ok"

    def forget(self, addr):
        with self._lock:
            self._status.pop(addr, None)
            self._states.pop(addr, None)

    def status(self) -> Dict[str, bool]:
        with self._lock:
            return {f"{a[0]}:{a[1]}": h for a, h in self._status.items()}

    def states(self) -> Dict[str, str]:
        """Per-backend verdict strings (the ``/healthz`` prober block's
        drain-aware view)."""
        with self._lock:
            return {f"{a[0]}:{a[1]}": self._states.get(a, "ok")
                    for a in set(self._status) | set(self._states)}


# ---------------------------------------------------------------------------
# Hedging
# ---------------------------------------------------------------------------

class LatencyTracker:
    """Sliding window of call durations → the p95 the hedge delay is
    derived from. Plain insertion-sort quantile over ≤ ``maxlen``
    samples — this runs once per request, not per token."""

    def __init__(self, maxlen: int = 64):
        self._samples: "collections.deque[float]" = collections.deque(
            maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, seconds: float):
        with self._lock:
            self._samples.append(float(seconds))

    def quantile(self, q: float = 0.95) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            s = sorted(self._samples)
        idx = min(int(q * len(s)), len(s) - 1)
        return s[idx]

    def __len__(self):
        with self._lock:
            return len(self._samples)


class HedgePolicy:
    """When and whether to hedge. The delay is the stage's observed p95
    (floored at ``min.delay.ms``) unless ``delay.ms`` pins it; the
    budget caps issued hedges at ``budget`` × routed requests (+1 so a
    cold router can still hedge its first straggler)."""

    def __init__(self, enabled: bool, delay_ms: float = 0.0,
                 min_delay_ms: float = 50.0, budget: float = 0.1):
        self.enabled = enabled
        self.delay_ms = delay_ms
        self.min_delay_ms = min_delay_ms
        self.budget = budget
        self._lock = threading.Lock()
        self.requests = 0
        self.hedges = 0

    def note_request(self):
        with self._lock:
            self.requests += 1

    def allow(self) -> bool:
        if not self.enabled:
            return False
        with self._lock:
            return self.hedges < self.budget * max(self.requests, 1) + 1

    def note_hedge(self):
        with self._lock:
            self.hedges += 1

    def delay_for(self, tracker: LatencyTracker) -> float:
        """Seconds to wait before duplicating the call."""
        if self.delay_ms and self.delay_ms > 0:
            return self.delay_ms / 1000.0
        p95 = tracker.quantile(0.95)
        floor = self.min_delay_ms / 1000.0
        return max(p95 if p95 is not None else floor, floor)


class Canceller:
    """Cancellation handle an attempt registers its live connection
    with. ``cancel()`` closes it from another thread — the loser of a
    hedge race sees its socket die, and the worker aborts the request
    (releasing its KV) when the stream write fails."""

    def __init__(self):
        self._lock = threading.Lock()
        self._conn = None
        self.cancelled = False

    def attach(self, conn):
        with self._lock:
            self._conn = conn
            if self.cancelled:
                self._close_locked()

    def _close_locked(self):
        conn, self._conn = self._conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:   # noqa: BLE001
                pass

    def cancel(self):
        with self._lock:
            self.cancelled = True
            self._close_locked()


def run_hedged(primary: Callable[[Canceller], Any],
               hedge: Optional[Callable[[Canceller], Any]],
               delay: float,
               on_hedge: Optional[Callable[[], None]] = None,
               prefer: Optional[Tuple[type, ...]] = None
               ) -> Tuple[Any, str]:
    """First-success-wins runner. ``primary``/``hedge`` take a
    :class:`Canceller` and either return a result or raise.

    Returns ``(result, outcome)`` with outcome one of ``"primary"``
    (no hedge launched), ``"primary_won"`` / ``"hedge_won"`` (hedge
    launched; the named attempt finished successfully first — the
    loser is cancelled). If every launched attempt fails the last
    error propagates (the router's failover loop handles it) —
    except that an error matching ``prefer`` wins over one that
    doesn't: the caller's backend-verdict exceptions (a 4xx to relay,
    a 503 shed) must not be masked by the other twin's later
    transport error, which would turn a should-be-relayed verdict
    into pointless failover retries. A fast primary *failure* before
    the delay is NOT hedged: hedging tames stragglers; failover
    handles failures.
    """
    if hedge is None:
        return primary(Canceller()), "primary"
    results: "queue.Queue[Tuple[int, str, Any]]" = queue.Queue()
    cancellers = (Canceller(), Canceller())

    def runner(idx: int, fn: Callable[[Canceller], Any]):
        try:
            results.put((idx, "ok", fn(cancellers[idx])))
        except BaseException as e:  # noqa: BLE001
            results.put((idx, "err", e))

    threading.Thread(target=runner, args=(0, primary),
                     daemon=True).start()
    try:
        first = results.get(timeout=max(delay, 0.0))
    except queue.Empty:
        first = None
    pending = 1
    hedged = False
    if first is None:
        hedged = True
        pending += 1
        if on_hedge is not None:
            on_hedge()
        threading.Thread(target=runner, args=(1, hedge),
                         daemon=True).start()
    last_err: Optional[BaseException] = None
    while True:
        idx, status, val = first if first is not None else results.get()
        first = None
        pending -= 1
        if status == "ok":
            # cancel the straggler; its worker aborts + releases KV
            cancellers[1 - idx].cancel()
            if not hedged:
                return val, "primary"
            return val, ("primary_won" if idx == 0 else "hedge_won")
        if last_err is None or prefer is None \
                or not isinstance(last_err, prefer):
            last_err = val
        if pending == 0:
            raise last_err

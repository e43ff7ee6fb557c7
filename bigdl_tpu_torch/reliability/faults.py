"""Fault-injection registry — the port of ``bigdl_tpu/reliability/faults.py``.

Named injection points sit in the serving paths whose failure handling
the engine promises, at the JAX package's calls::

    from bigdl_tpu_torch import reliability
    reliability.inject("llm.step")

In production ``inject`` is a no-op costing one module-attribute read
and one ``is None`` compare (``_state.plan``). Under a seeded test-mode
:class:`FaultPlan` the armed rules deterministically **raise**
(:class:`InjectedFault`), **delay** (``time.sleep``) or signal the call
site to **corrupt** its data (``inject`` returns ``"corrupt"``). Every
fired fault increments
``bigdl_reliability_injected_faults_total{site,action}`` so no injected
failure can be silently swallowed.

``SITES`` is the JAX package's list, kept whole so ``randomize`` draws
the same rules from the same seed in both packages. The port wires the
serving ones: ``llm.submit``, ``llm.step``, ``worker.stall``,
``llm.chunk``, ``llm.spec``, ``llm.preempt``, ``kvcache.evict`` and
``kvtier.spill`` / ``kvtier.fetch``; the training, cluster-serving,
router, elastic and fleet sites arrive with their modules.
"""

from __future__ import annotations

import fnmatch
import random
import threading
import time
from typing import Dict, List, Optional

from bigdl_tpu_torch.reliability import _state

#: The JAX package's injection points. Plans may arm any site name
#: (globs allowed); this list is what ``randomize`` samples.
SITES = (
    "checkpoint.write",            # save_checkpoint entry
    "checkpoint.write.arrays",     # after arrays land (corrupt-capable)
    "checkpoint.write.manifest",   # between arrays and manifest writes
    "checkpoint.commit",           # before the atomic rename
    "checkpoint.load",             # load_checkpoint entry
    "optimizer.step",              # top of each training iteration
    "optimizer.checkpoint",        # before the optimizer persists state
    "serving.backend.push",        # queue backend write
    "serving.backend.pop",         # queue backend read
    "serving.batch",               # cluster-serving batch execution
    "serving.frontend.request",    # HTTP /predict admission
    "llm.submit",                  # LLMServer request admission
    "llm.step",                    # LLM engine decode step
    "llm.chunk",                   # between chunks of one chunked
                                   # admission
    "kvcache.evict",               # prefix-cache LRU eviction
    "kvtier.spill",                # HBM->host page spill
    "kvtier.fetch",                # host->HBM page fetch
    "router.dispatch",             # router->backend call/stream
    "worker.stall",                # hung engine decode step
    "elastic.heartbeat",           # agent->supervisor beat
    "elastic.step",                # elastic-guarded train step
    "federation.scrape",           # fleet collector member scrape
    "fleet.scale",                 # autoscaler scale action
    "worker.drain",                # per-chain drain migration
    "llm.preempt",                 # before a victim's KV chain is
                                   # exported
    "llm.spec",                    # between drafting and the verify
                                   # dispatch
)


class InjectedFault(RuntimeError):
    """Raised by an armed ``raise`` rule. Deliberately a RuntimeError:
    recovery paths must treat it like any real fault, never special-case
    it (special-casing would make the chaos suite test nothing)."""


class FaultPlan:
    """A seeded, deterministic schedule of faults.

    Rules are matched in insertion order against the site name
    (``fnmatch`` globs, so ``checkpoint.*`` arms the whole family)::

        plan = FaultPlan(seed=7)
        plan.add("checkpoint.write.manifest", "raise", after=1, times=1)
        plan.add("serving.backend.pop", "delay", delay=0.05, times=3)
        plan.add("checkpoint.write.arrays", "corrupt", times=1)
        reliability.set_plan(plan)

    ``after`` skips the first N calls of the site; ``times`` bounds how
    often the rule fires (None = forever); ``prob`` gates each firing on
    the plan's own seeded RNG, so "randomized" chaos runs are exactly
    reproducible from the seed.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._rules: List[Dict] = []
        self._calls: Dict[str, int] = {}
        self._lock = threading.Lock()
        #: chronological log of fired faults: (site, action) tuples —
        #: the chaos harness asserts injected == recovered from this.
        self.fired: List[tuple] = []

    def add(self, site: str, action: str = "raise", *, times: Optional[int] = 1,
            after: int = 0, delay: float = 0.01, prob: float = 1.0,
            exc: Optional[BaseException] = None) -> "FaultPlan":
        if action not in ("raise", "delay", "corrupt"):
            raise ValueError(f"unknown fault action {action!r}")
        self._rules.append({"site": site, "action": action, "times": times,
                            "after": after, "delay": delay, "prob": prob,
                            "exc": exc, "fired": 0, "seen": 0})
        return self

    def randomize(self, n: int, sites=SITES,
                  actions=("raise", "delay", "corrupt")) -> "FaultPlan":
        """Arm ``n`` random-but-seeded rules over ``sites`` (the chaos
        harness entry). Corrupt rules only make sense on corrupt-capable
        sites, so they are pinned to ``checkpoint.write.arrays``."""
        for _ in range(n):
            action = self._rng.choice(list(actions))
            site = ("checkpoint.write.arrays" if action == "corrupt"
                    else self._rng.choice(list(sites)))
            self.add(site, action, times=1,
                     after=self._rng.randint(0, 2),
                     delay=self._rng.uniform(0.001, 0.02))
        return self

    def sites(self) -> List[str]:
        """Site patterns this plan has armed (empty once disarmed)."""
        return sorted({r["site"] for r in self._rules})

    # -- firing --------------------------------------------------------------
    def fire(self, site: str) -> Optional[str]:
        with self._lock:
            self._calls[site] = self._calls.get(site, 0) + 1
            decision = None
            for r in self._rules:
                if not fnmatch.fnmatch(site, r["site"]):
                    continue
                r["seen"] += 1
                if r["seen"] <= r["after"]:
                    continue
                if r["times"] is not None and r["fired"] >= r["times"]:
                    continue
                if r["prob"] < 1.0 and self._rng.random() >= r["prob"]:
                    continue
                r["fired"] += 1
                decision = r
                break
            if decision is None:
                return None
            self.fired.append((site, decision["action"]))
        _count_injected(site, decision["action"])
        if decision["action"] == "delay":
            time.sleep(decision["delay"])
            return "delay"
        if decision["action"] == "raise":
            raise decision["exc"] or InjectedFault(
                f"injected fault at {site!r}")
        return "corrupt"


def _count_injected(site: str, action: str):
    from bigdl_tpu_torch import observability as obs
    if obs.enabled():
        obs.counter(
            "bigdl_reliability_injected_faults_total",
            "Faults fired by the armed FaultPlan",
            labelnames=("site", "action")).labels(
                site=site, action=action).inc()


def inject(site: str) -> Optional[str]:
    """The injection point. Production fast path: one attribute read +
    ``is None`` — nothing else executes. Test mode: the armed plan may
    raise :class:`InjectedFault`, sleep, or return ``"corrupt"``."""
    plan = _state.plan
    if plan is None:
        return None
    return plan.fire(site)


def set_plan(plan: Optional[FaultPlan]):
    """Arm (or with ``None`` disarm) a fault plan. Requires the
    reliability layer enabled — a disabled process must stay structurally
    fault-free (the zero-overhead contract)."""
    if plan is not None and not _state.enabled:
        raise RuntimeError(
            "bigdl.reliability.enabled=false: fault plans cannot be armed "
            "in a disabled process")
    _state.plan = plan


def active_plan() -> Optional[FaultPlan]:
    return _state.plan


def armed_sites() -> List[str]:
    """Site patterns currently armed; ``[]`` in production/disabled mode
    (asserted by the disabled-mode no-op test)."""
    plan = _state.plan
    return plan.sites() if plan is not None else []

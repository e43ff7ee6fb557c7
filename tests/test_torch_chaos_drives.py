"""The port's chaos drives (``bigdl_tpu_torch.llm.chaos``) against the
JAX drives of ``tools/chaos_check.py`` on the same seed, on the CPU:
the training drive (``run_chaos``), the prefix-cache and host-tier
drives, and the engine-mode drives (``--mixed``, ``--spec``,
``--flight``, ``--preempt``, ``--api``). Each passes its own contract,
and the two records have the same keys and outcome. The armed plans are
the same seeded rules in both packages, so the fired events are equal
too, less the unbounded delay rules that fire once an engine pass (or a
speculative tick), a count that timing or the weights set. The record
keys each package computes from its own weights (the losses, the
speculation tallies) or reads off the wall clock (TTFT) are its own.

Also here: the repairs of two races in the port's alerts and fleet
drives, each forced."""

import json

import pytest

from tools import chaos_check as jchaos

from bigdl_tpu_torch.llm import chaos


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


# the record keys each package computes from its own weights, or reads
# off the wall clock
OWN = {"clean_loss", "injected_loss", "spec_passes", "proposed", "accepted",
       "flight_events", "interactive_ttft_on_ms", "interactive_ttft_off_ms"}
# the unbounded delay rule of each drive that has one firing once an
# engine pass or a speculative tick
PER_PASS = {"spec": "llm.spec:delay", "flight": "llm.step:delay",
            "preempt": "llm.step:delay", "api": "llm.step:delay"}
SMOKE = {"preempt", "api"}


@pytest.mark.parametrize("name", ["chaos", "kvcache", "kvtier", "mixed",
                                  "spec", "flight", "preempt", "api"])
def test_drive_equals_the_jax_drive(name):
    run = {"chaos": "run_chaos", "kvcache": "run_kvcache_chaos",
           "kvtier": "run_kvtier_chaos", "mixed": "run_mixed_chaos",
           "spec": "run_spec_chaos", "flight": "run_flight_chaos",
           "preempt": "run_preempt_chaos", "api": "run_api_chaos"}[name]
    kw = {"smoke": True} if name in SMOKE else {}
    got = getattr(chaos, run)(seed=1, device="cpu", **kw)
    want = getattr(jchaos, run)(seed=1, **kw)
    assert set(got) == set(want)
    assert got["match"] is want["match"] is True
    assert got["events_fired"]

    def fired(rec):
        return [e for e in rec["events_fired"] if e != PER_PASS.get(name)]
    assert fired(got) == fired(want)
    for k in set(want) - OWN - {"events_fired"}:
        assert got[k] == want[k], k
    if name == "chaos":
        assert got["clean_loss"] == pytest.approx(got["injected_loss"],
                                                  rel=1e-4)


def test_drive_flags(monkeypatch, capsys):
    """``--chaos`` runs the smoke training run unless ``--full`` and takes
    ``--events``; ``--kvcache``, ``--kvtier``, ``--mixed`` and ``--spec``
    take the seed and the device, ``--flight``, ``--preempt`` and
    ``--api`` also ``--smoke``; the real ``--kvtier`` drive prints its
    record."""
    calls = []
    for name in ("chaos", "kvcache", "mixed", "spec", "flight", "preempt",
                 "api"):
        monkeypatch.setitem(chaos.DRIVES, name,
                            lambda **kw: calls.append(kw) or {"match": True})
    assert chaos.main(["--chaos", "--device", "cpu"]) == 0
    assert chaos.main(["--chaos", "--full", "--events", "3"]) == 0
    assert chaos.main(["--kvcache", "--seed", "2"]) == 0
    for flag in ("--mixed", "--spec"):
        assert chaos.main([flag, "--seed", "3", "--device", "cpu"]) == 0
    for flag in ("--flight", "--preempt", "--api"):
        assert chaos.main([flag, "--smoke"]) == 0
    assert calls == [dict(seed=0, device="cpu", smoke=True, events=5),
                     dict(seed=0, device=None, smoke=False, events=3),
                     dict(seed=2, device=None)] + \
        [dict(seed=3, device="cpu")] * 2 + \
        [dict(seed=0, device=None, smoke=True)] * 3
    capsys.readouterr()
    assert chaos.main(["--kvtier", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["drive"] == "kvtier" and out["ok"] and out["clean_fetches"]


def _capture_starts(monkeypatch, cls):
    """Every instance of ``cls`` whose ``start`` runs, in order."""
    seen, start = [], cls.start

    def capture(self, *a, **kw):
        seen.append(self)
        return start(self, *a, **kw)
    monkeypatch.setattr(cls, "start", capture)
    return seen


def test_alerts_storm_tail_does_not_reach_the_clean_traffic(monkeypatch):
    """The race, forced: just before the storm's disarm, the engine the
    router picks for the first recovery request draws a fresh 0.6 s
    ``llm.step`` delay while the other engine (which takes the hold
    request) draws none. Unrepaired, the recovery request waits out that
    delay, past the 500 ms TTFT objective, and the alert does not
    resolve; the drive now waits for every engine's next pass after the
    disarm, so the delay has run out before any clean request."""
    import threading
    import time

    from bigdl_tpu_torch import reliability as rel
    from bigdl_tpu_torch.llm.serving import LLMServer
    from bigdl_tpu_torch.llm.worker import LLMRouter, LLMWorker

    servers = _capture_starts(monkeypatch, LLMServer)
    workers = _capture_starts(monkeypatch, LLMWorker)
    routers = _capture_starts(monkeypatch, LLMRouter)
    real_set_plan, forced = rel.set_plan, []

    def set_plan(plan):
        storm = rel.active_plan()
        if plan is not None or forced or storm is None or not any(
                r["site"] == "llm.step" for r in storm._rules):
            return real_set_plan(plan)
        forced.append(True)
        router = routers[-1]
        with router._pool_lock:
            pool = [tuple(a) for a in router.decode_workers]
            nxt = router._rr["decode"]
        # the hold request goes to pool[nxt], the first recovery request
        # to the other engine: that one draws the delay
        late = next(w.server for w in workers[-2:]
                    if tuple(w.address) == pool[(nxt + 1) % len(pool)])
        tail = rel.FaultPlan(seed=0).add("llm.step", "delay", times=None,
                                         delay=0.6)
        fire = tail.fire
        tail.fire = lambda site: (fire(site) if threading.current_thread()
                                  is late._thread else None)
        real_set_plan(tail)
        t = time.monotonic()
        while any(s._hb <= t for s in servers[-2:]):
            time.sleep(0.001)
        real_set_plan(None)

    monkeypatch.setattr(rel, "set_plan", set_plan)
    out = chaos.run_alerts_chaos(device="cpu", smoke=True)
    assert forced and out["alert_events"] == {"fire": 1, "resolve": 1}


def test_fleet_spike_phases_hold_a_pressured_tick(monkeypatch):
    """Each spike phase holds its queue above ``queue_high`` for at least
    one controller tick (``FleetController.decisions``), so the scale-out
    no longer races the spike's drain."""
    from bigdl_tpu_torch.llm.worker import LLMRouter

    routers = _capture_starts(monkeypatch, LLMRouter)
    out = chaos.run_fleet_chaos(device="cpu", smoke=True)
    fleet = next(r._fleet for r in routers if r._fleet is not None)
    for name in ("spike", "respike"):
        lo, hi = out["phases"][name]["ticks"]
        pressured = [d for d in fleet.decisions
                     if lo < d["tick"] <= hi and d["pressure"]]
        assert pressured, (name, fleet.decisions)
        assert max(d["queue"] for d in pressured) > fleet.queue_high
        assert out["phases"][name]["pressured_ticks"] == len(pressured)

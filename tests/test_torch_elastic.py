"""The port's elastic training (``bigdl_tpu_torch.elastic``, the elastic
branch of ``BaseOptimizer.optimize``, ``Engine.reinit_distributed`` and
``llm.chaos.run_elastic_chaos``) held to the JAX package on the CPU.

- The state machines: one script of calls on a fake clock drives the
  JAX object and the port's (``SnapshotRing``, ``Supervisor``,
  ``ElasticAgent``, the supervisor's HTTP surface); every return value,
  status, commit floor, directive and abort reason must be equal.
- The optimizer: a stalled step's in-process rollback gives weights bit
  for bit equal to the clean run (an MLP, and one with a dropout layer,
  whose generator state travels in the snapshot); the clean MLP run
  equals the JAX package's on the same weights and data within 1e-6
  (f32 sums in another order); the snapshot cadence, the durable
  flushes, the restart budget, auto-resume without the reliability
  switch, the world-size guard and the disabled plane's absence.
- The launcher's four cases of ``tests/test_elastic.py`` (workers that
  import nothing of either package) and the Engine's rejoin.
- ``run_elastic_chaos(device="cpu")``: two gloo ranks under the
  launcher, a seeded kill, the restart and equal weight hashes; its
  clean weights equal a JAX ``LocalOptimizer`` run of the same MLP on
  the full batches within 1e-5 (at W = 2 the averaged gradient is the
  full batch's).
"""

import os
import socket
import sys
import threading

import numpy as np
import pytest

import jax

import bigdl_tpu.nn as jnn
from bigdl_tpu import elastic as jel
from bigdl_tpu import observability as jobs
from bigdl_tpu import reliability as jrel
from bigdl_tpu.elastic import supervisor as jsup
from bigdl_tpu.feature.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.nn.module import set_seed as jset_seed
from bigdl_tpu.optim.optim_method import SGD as JSGD
from bigdl_tpu.optim.optimizer import LocalOptimizer as JLocalOptimizer
from bigdl_tpu.optim.trigger import Trigger as JTrigger
from bigdl_tpu.utils.conf import conf as jconf

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import elastic as tel
from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch import reliability as trel
from bigdl_tpu_torch.elastic import supervisor as tsup
from bigdl_tpu_torch.feature.dataset import LocalDataSet
from bigdl_tpu_torch.optim.optim_method import SGD
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils import checkpoint as tckpt
from bigdl_tpu_torch.utils.conf import conf
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.tree import tree_leaves

_KEYS = ("bigdl.elastic.enabled", "bigdl.elastic.snapshot.every",
         "bigdl.elastic.snapshot.ring", "bigdl.elastic.step.timeout",
         "bigdl.elastic.heartbeat.interval", "bigdl.elastic.max.restarts",
         "bigdl.elastic.supervisor.address",
         "bigdl.elastic.snapshot.flush.every")


@pytest.fixture(autouse=True)
def _clean_elastic_state():
    for rel, obs in ((jrel, jobs), (trel, tobs)):
        rel.enable()
        rel.set_plan(None)
        obs.reset()
    yield
    for rel, obs in ((jrel, jobs), (trel, tobs)):
        rel.set_plan(None)
        obs.reset()
    for key in _KEYS:
        conf.unset(key)
        jconf.unset(key)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Pkg:
    """One package's elastic surface, for scripts that run on either."""

    def __init__(self, el, sup, rel, obs):
        self.el, self.sup, self.rel, self.obs = el, sup, rel, obs

    def counter(self, name, **labels):
        m = self.obs.REGISTRY.get(name)
        if m is None:
            return 0.0
        return (m.labels(**labels) if labels else m).value


JAX = _Pkg(jel, jsup, jrel, jobs)
PORT = _Pkg(tel, tsup, trel, tobs)


# ---------------------------------------------------------------------------
# the state machines, one script each, run on both packages
# ---------------------------------------------------------------------------

def _ring_script(pkg):
    out = []
    ring = pkg.el.SnapshotRing(capacity=3)
    for s in (5, 10, 15, 20):
        ring.take(s, {"w": np.full(2, s)}, {}, {"m": s}, {"seed": 0},
                  {"neval": s})
    out += [ring.steps(), ring.taken, ring.newest_committed()]
    out += [ring.commit(15), ring.committed_steps(), ring.commit(15)]
    ent = ring.rollback()
    out += [ent.step, ent.train_state, ring.steps(), ring.rollback().step,
            ring.rollbacks, len(ring)]
    fresh = pkg.el.SnapshotRing(capacity=2)
    fresh.take(5, {}, {}, {}, {}, {})
    out += [fresh.rollback(), len(fresh)]
    auto = pkg.el.SnapshotRing(capacity=2, auto_commit=True)
    auto.take(5, {}, {}, {}, {}, {})
    out += [auto.newest_committed().step, auto.rollback().step,
            auto.committed]
    return out


def _supervisor_script(pkg):
    clk = FakeClock()
    out = []
    sup = pkg.sup.Supervisor(expected=2, heartbeat_timeout=5.0,
                             join_timeout=30.0, clock=clk)
    out.append(sup.heartbeat(pid=0, step=4, snap_step=3))
    out.append(sup.heartbeat(pid=1, step=5, snap_step=5))
    out += [sup.live_peers(), sup.step_skew(), sup.committed_step]
    sup.heartbeat(pid=0, step=8, snap_step=7)
    out.append(sup.heartbeat(pid=1, step=8, snap_step=7))
    clk.advance(3.0)
    out.append(sup.heartbeat(pid=0, step=9))
    clk.advance(3.0)                    # peer 1 silent for 6 s > 5 s
    out.append(sup.heartbeat(pid=0, step=9))
    out += [sup.state, sup.expiries, sup.sweep(), sup.status()]
    out.append(sup.begin_generation())
    out += [sup.state, sup.live_peers(), sup.committed_step]
    out.append(sup.heartbeat(pid=0, generation=0))   # a ghost
    out.append(sup.heartbeat(pid=0, generation=1, snap_step=9))
    out.append(sup.heartbeat(pid=1, generation=1, status="stall", step=7))
    out += [sup.stalls, sup.heartbeat(pid=0, generation=1)]
    sup.begin_generation()
    sup.heartbeat(pid=0, generation=2, snap_step=10)
    sup.heartbeat(pid=1, generation=2, snap_step=10)
    sup.leave(1)                        # a clean exit
    clk.advance(60.0)
    out.append(sup.heartbeat(pid=0, generation=2, snap_step=20))
    out += [sup.sweep(), sup.state]
    sup.begin_generation()
    sup.heartbeat(pid=0, generation=3)  # peer 1 never joins
    clk.advance(20.0)
    out.append(sup.heartbeat(pid=0, generation=3))
    clk.advance(15.0)
    out.append(sup.heartbeat(pid=0, generation=3))
    sup.fail("process 1 exited with code 17")
    out += [sup.status(), sup.failures]
    try:
        sup.heartbeat(pid=0, generation=4, metrics_addr=["h"])
    except ValueError as e:
        out.append(str(e))
    return out


def _agent_script(pkg):
    clk = FakeClock()
    out = []
    agent = pkg.el.ElasticAgent(process_id=0, step_timeout=2.0,
                                heartbeat_interval=0.1, clock=clk)
    out.append(agent.check_stall())     # no step seen: not live
    agent.step_heartbeat(5)
    clk.advance(1.0)
    out.append(agent.check_stall())
    clk.advance(1.5)                    # 2.5 s > 2.0 s: wedged
    out += [agent.check_stall(), agent.should_abort(),
            agent.abort_reason(), agent.stalls]
    agent.check_stall()                 # still stalled, counted once
    out += [agent.stalls, pkg.counter("bigdl_elastic_stalls_total")]
    agent.reset_abort()
    agent.step_heartbeat(6)
    agent.loop_idle()                   # epoch-boundary work parks it
    clk.advance(60.0)
    out.append(agent.check_stall())
    ring = pkg.el.SnapshotRing(capacity=4)
    ring.take(7, {}, {}, {}, {}, {"neval": 7})
    sent, replies = [], [
        {"directive": "ok", "generation": 0, "committed_step": 7},
        {"directive": "abort", "generation": 1, "committed_step": 7,
         "reason": "world restarting"}]

    def transport(payload):
        sent.append(dict(payload))
        return dict(replies[min(len(sent), len(replies)) - 1])

    agent = pkg.el.ElasticAgent(process_id=3, ring=ring,
                                transport=transport, step_timeout=1.0,
                                heartbeat_interval=0.1, generation=0,
                                clock=clk)
    agent.step_heartbeat(9)
    agent.note_snapshot(7)
    out += [agent.beat(), ring.newest_committed().step,
            agent.should_abort()]
    out += [agent.beat(), agent.should_abort(), agent.abort_reason()]
    agent.reset_abort()
    agent.step_heartbeat(10)
    clk.advance(5.0)
    agent.beat()
    out += [sent, agent.beats, agent.has_supervisor,
            pkg.counter("bigdl_elastic_heartbeats_total")]
    plan = pkg.rel.FaultPlan(seed=0)
    plan.add("elastic.heartbeat", "raise", times=1)
    pkg.rel.set_plan(plan)
    try:
        agent.beat()
    except pkg.rel.InjectedFault as e:
        out.append(str(e))
    pkg.rel.set_plan(None)
    out.append(agent.beats)
    idle = pkg.el.ElasticAgent(process_id=0, step_timeout=0,
                               heartbeat_interval=0.01)
    idle.start()
    out.append(idle._thread is None)    # no supervisor, no watchdog
    return out


def _http_script(pkg):
    import http.client
    import json

    sup = pkg.sup.Supervisor(expected=1, heartbeat_timeout=60.0).start()
    out = []
    try:
        host, port = sup.address

        def call(method, path, body=None):
            c = http.client.HTTPConnection(host, port, timeout=5)
            try:
                c.request(method, path, json.dumps(body) if body else None)
                r = c.getresponse()
                return r.status, json.loads(r.read().decode())
            finally:
                c.close()

        out.append(call("POST", "/elastic/heartbeat",
                        {"pid": 0, "step": 3, "snap_step": 2}))
        st, status = call("GET", "/elastic/status")
        for peer in status["peers"].values():
            peer.pop("age_s")           # wall-clock dependent
        out += [st, status, call("GET", "/healthz")]
        sup.fail("test failure")
        out += [call("GET", "/healthz"),
                call("POST", "/elastic/heartbeat", {"pid": "x"}),
                call("GET", "/nowhere"), call("POST", "/nowhere", {})]
    finally:
        sup.stop()
    return out


@pytest.mark.parametrize("script", [_ring_script, _supervisor_script,
                                    _agent_script, _http_script],
                         ids=["ring", "supervisor", "agent", "http"])
def test_state_machine_matches_jax(script):
    jobs.enable()
    tobs.enable()
    assert script(PORT) == script(JAX)


# ---------------------------------------------------------------------------
# the optimizer: rollback, cadence, flushes, budget, resume, absence
# ---------------------------------------------------------------------------

_DATA = np.random.RandomState(0)
_X = _DATA.randn(64, 8).astype(np.float32)
_T = (_DATA.randint(0, 4, 64) + 1).astype(np.int32)


def _mlp(nn, dropout=False):
    m = nn.Sequential().add(nn.Linear(8, 16)).add(nn.ReLU())
    if dropout:
        # a fixed name: the layer's generator is seeded from it
        m.add(nn.Dropout(0.3).set_name("elastic_drop"))
    return m.add(nn.Linear(16, 4)).add(nn.LogSoftMax())


def _weights(model):
    return [p.detach().numpy().copy()
            for p in tree_leaves(model.parameters_dict())]


def _elastic_conf(**keys):
    conf.set("bigdl.elastic.enabled", "true")
    conf.set("bigdl.elastic.snapshot.every", "2")
    conf.set("bigdl.elastic.step.timeout", "0")
    conf.set("bigdl.elastic.heartbeat.interval", "0.05")
    for k, v in keys.items():
        conf.set("bigdl.elastic." + k.replace("_", "."), str(v))


def _train(elastic_on=False, plan=None, epochs=3, dropout=False,
           init=None, ckpt=None, ckpt_trigger=None, **keys):
    tnn.set_seed(0)
    model = _mlp(tnn, dropout)
    if init is not None:
        model.load_parameters_dict(init)
    opt = LocalOptimizer(model, LocalDataSet(_X, _T, shuffle=False),
                         tnn.ClassNLLCriterion(), batch_size=16,
                         end_trigger=Trigger.max_epoch(epochs),
                         device="cpu").set_optim_method(SGD(0.1))
    if ckpt is not None:
        opt.set_checkpoint(ckpt, ckpt_trigger or Trigger.every_epoch())
    if elastic_on:
        _elastic_conf(**keys)
    trel.set_plan(plan)
    try:
        opt.optimize()
    finally:
        trel.set_plan(None)
        for k in _KEYS:
            conf.unset(k)
    return opt, _weights(opt.model)


@pytest.mark.parametrize("dropout", [False, True],
                         ids=["mlp", "dropout"])
def test_stall_recovery_is_bit_identical_to_clean_run(dropout):
    """One wedged step (an injected delay past the watchdog timeout):
    stall detected, in-process rollback to the last committed snapshot,
    replay; the final weights equal the uninterrupted run's bit for
    bit."""
    tobs.enable()
    _, w_clean = _train(dropout=dropout)
    plan = trel.FaultPlan(seed=0)
    plan.add("elastic.step", "delay", times=1, after=6, delay=1.2)
    opt, w_el = _train(True, plan, dropout=dropout, step_timeout=0.5)
    assert plan.fired == [("elastic.step", "delay")]
    assert opt._elastic.agent.stalls == 1
    assert opt._elastic.ring.rollbacks == 1
    for a, b in zip(w_clean, w_el):
        np.testing.assert_array_equal(a, b)
    assert PORT.counter("bigdl_elastic_restarts_total",
                        scope="in_process") == 1
    assert PORT.counter("bigdl_elastic_snapshots_total") > 0


def test_clean_weights_match_jax():
    """The port's clean run of the MLP against the JAX package's on the
    same initial weights and batches: within 1e-6."""
    jset_seed(0)
    jm = _mlp(jnn)
    init = jax.tree_util.tree_map(np.asarray, jm.parameters_dict())
    jopt = JLocalOptimizer(jm, JLocalDataSet(_X, _T, shuffle=False),
                           jnn.ClassNLLCriterion(), batch_size=16,
                           end_trigger=JTrigger.max_epoch(3))
    jopt.set_optim_method(JSGD(0.1)).optimize()
    want = [np.asarray(v) for v in
            jax.tree_util.tree_leaves(jopt.model.parameters_dict())]
    _, got = _train(init=init)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def _case_cadence(tmp_path):
    tobs.enable()
    tobs.TRACE.clear()
    opt, _ = _train(True)
    # 12 iterations at every=2 -> 6 snapshots, the ring keeps the newest
    # 2, and each holds copies the later steps did not touch
    assert opt._elastic.ring.taken == 6 and len(opt._elastic.ring) == 2
    assert opt._elastic.ring.newest_committed().step == 13
    assert opt._elastic.ring.nbytes() > 0
    assert len([r for r in tobs.TRACE.spans()
                if r["name"] == "elastic/snapshot"]) == 6
    first = opt._elastic.ring.steps()[0]
    ent = next(e for e in opt._elastic.ring._entries if e.step == first)
    assert not all(np.array_equal(a.numpy(), b) for a, b in zip(
        tree_leaves(ent.params), _weights(opt.model)))


def _case_flush_every(tmp_path):
    tobs.enable()
    # a trigger far out of reach: every tag on disk is an elastic flush
    opt, _ = _train(True, ckpt=str(tmp_path),
                    ckpt_trigger=Trigger.several_iteration(10**9),
                    snapshot_flush_every=2)
    # 12 iterations -> 6 committed snapshots -> 3 durable flushes
    assert opt._elastic.ring.taken == 6
    assert PORT.counter("bigdl_elastic_flushes_total") == 3
    assert len([t for t in os.listdir(tmp_path)
                if t.startswith("optim.")]) == 3
    # a flushed ring entry resumes like a trigger checkpoint
    tag = tckpt.latest(str(tmp_path), prefix="optim.",
                       paired_prefix="model.")
    opt2, _ = _train(epochs=1)
    opt2.resume_from_checkpoint(str(tmp_path), tag)
    assert opt2.state["neval"] == int(tag.split(".")[1])


def _case_budget(tmp_path):
    plan = trel.FaultPlan(seed=0)
    # every step wedges: the budget (1) runs out and surfaces
    plan.add("elastic.step", "delay", times=None, delay=0.6)
    with pytest.raises(tel.ElasticRestart):
        _train(True, plan, step_timeout=0.3, max_restarts=1)


def _case_auto_resume(tmp_path):
    """A restarted generation with bigdl.reliability.enabled=false still
    resumes from the durable tier at the exact saved iteration."""
    _train(epochs=1, ckpt=str(tmp_path))        # seeds the durable tier
    saved = tckpt.latest(str(tmp_path), paired_prefix="model.")
    assert saved is not None
    trel.disable()
    seen = {}
    orig = LocalOptimizer._optimize_once

    def capture(self):
        seen.setdefault("neval", self.state["neval"])
        return orig(self)

    LocalOptimizer._optimize_once = capture
    try:
        _train(True, epochs=2, ckpt=str(tmp_path))
    finally:
        LocalOptimizer._optimize_once = orig
        trel.enable()
    assert seen["neval"] == int(saved.split(".")[1])


def _case_world_guard(tmp_path):
    _train(epochs=1, ckpt=str(tmp_path))
    tag = tckpt.latest(str(tmp_path), paired_prefix="model.")
    blob, _ = tckpt.load_checkpoint(str(tmp_path / f"optim.{tag}"))
    assert blob["world"] == {"processes": 1, "devices": 1}
    blob["world"] = {"processes": 4, "devices": 32}
    tckpt.save_checkpoint(str(tmp_path / f"optim.{tag}"), blob)
    opt2, _ = _train(epochs=1)
    neval = opt2.state["neval"]
    with pytest.raises(ValueError, match="different world"):
        opt2.resume_from_checkpoint(str(tmp_path), tag)
    assert opt2.state["neval"] == neval      # the refusal left it as it was


def _case_disabled(tmp_path):
    tobs.enable()
    before = set(tobs.render().splitlines())
    opt, _ = _train(epochs=1)
    assert opt._elastic is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith("bigdl-elastic")]
    grown = "\n".join(set(tobs.render().splitlines()) - before)
    assert "bigdl_elastic_" not in grown


@pytest.mark.parametrize("case", [_case_cadence, _case_flush_every,
                                  _case_budget, _case_auto_resume,
                                  _case_world_guard, _case_disabled],
                         ids=["cadence", "flush_every", "restart_budget",
                              "auto_resume_without_reliability",
                              "world_size_guard", "disabled_absent"])
def test_optimizer_elastic_contract(case, tmp_path):
    case(tmp_path)


# ---------------------------------------------------------------------------
# the launcher and the Engine's rejoin
# ---------------------------------------------------------------------------

_EXIT_BY_GENERATION = (
    "import os, sys; "
    "sys.exit(0 if int(os.environ['BIGDL_TPU_ELASTIC_GENERATION']) >= %d "
    "else %d)")
_SEES_ENV = (
    "import os; "
    "assert os.environ['BIGDL_TPU_ELASTIC_ENABLED'] == 'true'; "
    "assert ':' in os.environ['BIGDL_TPU_ELASTIC_SUPERVISOR_ADDRESS']; "
    "assert os.environ['BIGDL_TPU_NUM_PROCESSES'] == '2'; "
    "assert os.environ['BIGDL_TPU_PROCESS_ID'] in ('0', '1'); "
    "assert ':' in os.environ['BIGDL_TPU_COORDINATOR_ADDRESS']")


@pytest.mark.parametrize("code, max_restarts, want", [
    ("print('ok')", 1, (0, [0, 0], False)),
    (_EXIT_BY_GENERATION % (1, 7), 2, (1, [0, 0], "code 7")),
    ("import sys; sys.exit(3)", 1, None),
    (_SEES_ENV, 0, (0, [0, 0], False)),
], ids=["clean_set", "failed_generation_restarted", "budget_exhausted",
        "workers_see_the_env"])
def test_launcher(code, max_restarts, want, tmp_path):
    from bigdl_tpu_torch.elastic.launch import (ElasticJobFailed,
                                                ElasticLauncher)
    launcher = ElasticLauncher([sys.executable, "-c", code], nprocs=2,
                               poll_interval=0.05, grace=2.0,
                               env=dict(os.environ),
                               max_restarts=max_restarts,
                               log_dir=str(tmp_path))
    if want is None:
        with pytest.raises(ElasticJobFailed) as ei:
            launcher.run(timeout=60)
        assert "restart budget exhausted" in str(ei.value)
        assert ei.value.log_tails            # diagnostics attached
        return
    rec = launcher.run(timeout=60)
    restarts, codes, failure = want
    assert rec["restarts"] == restarts and rec["exit_codes"] == codes
    if failure:
        assert any(failure in f for f in rec["failures"])
    else:
        assert rec["failures"] == []


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("wedged", [False, True],
                         ids=["tears_down_and_rejoins",
                              "survives_a_wedged_teardown"])
def test_reinit_distributed(wedged, monkeypatch):
    import torch.distributed as dist
    Engine.reset()
    try:
        Engine.init(engine_type="cpu")
        old = dist.group.WORLD
        if wedged:
            def stuck():
                raise RuntimeError("group wedged on a dead peer")
            monkeypatch.setattr(dist, "destroy_process_group", stuck)
        addr = f"127.0.0.1:{_free_port()}"
        mesh = Engine.reinit_distributed(addr, num_processes=1,
                                         process_id=0, engine_type="cpu")
        assert mesh is not None and Engine.is_initialized()
        assert Engine.config().coordinator_address == addr
        assert dist.group.WORLD is not old
    finally:
        monkeypatch.undo()
        Engine.reset()


# ---------------------------------------------------------------------------
# the --elastic chaos drive
# ---------------------------------------------------------------------------

def test_elastic_chaos_contract():
    from bigdl_tpu_torch.llm.chaos import run_elastic_chaos
    rs = np.random.RandomState(0)
    x = rs.rand(256, 10).astype(np.float32)
    y = (x.sum(1) > 5).astype(np.int32) + 1
    jset_seed(0)
    jm = (jnn.Sequential().add(jnn.Linear(10, 16)).add(jnn.ReLU())
          .add(jnn.Linear(16, 2)).add(jnn.LogSoftMax()))
    init = jax.tree_util.tree_map(np.asarray, jm.parameters_dict())
    out = run_elastic_chaos(device="cpu", smoke=True, init=init)
    assert out["match"] and out["kill"]["restarts"] >= 1
    assert out["clean"]["restarts"] == 0 and out["resumed_at"]
    assert any("code 17" in f for f in out["kill_failures"])
    jopt = JLocalOptimizer(jm, JLocalDataSet(x, y, shuffle=False),
                           jnn.ClassNLLCriterion(), batch_size=64,
                           end_trigger=JTrigger.max_epoch(3))
    jopt.set_optim_method(JSGD(learning_rate=0.5)).optimize()
    want = [np.asarray(v) for v in
            jax.tree_util.tree_leaves(jopt.model.parameters_dict())]
    got = tree_leaves(out["clean_weights"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)

"""The port's ``optim`` held to the JAX package on the CPU: each optim
method's five steps on one parameter tree (params and slots, rtol 1e-5 /
atol 1e-6), each schedule's rates, the validation methods, triggers and
summaries, and ``LocalOptimizer`` itself — 20 LeNet-5 iterations on the
same shuffled batches (loss trajectory and weights within 2e-4), both
gradient clippings, the checkpoint resume (bit-equal to the uninterrupted
run), ``set_max_retry``'s replay after an injected fault and the
preemption round trip (bit-equal on the port)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
import bigdl_tpu.optim.optim_method as jom
from bigdl_tpu.feature.dataset import LocalDataSet as JLocalDataSet
from bigdl_tpu.feature.mnist import load_mnist as jload_mnist, normalize
from bigdl_tpu.models import lenet as jlenet

import bigdl_tpu_torch.nn as tnn
import bigdl_tpu_torch.optim as toptim
import bigdl_tpu_torch.optim.optim_method as tom
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.feature.dataset import (DistributedDataSet,
                                             LocalDataSet)
from bigdl_tpu_torch.feature.mnist import load_mnist
from bigdl_tpu_torch.models import lenet as tlenet
from bigdl_tpu_torch.utils import checkpoint as tckpt
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _leaves_np(tree):
    return [np.asarray(a.detach() if isinstance(a, torch.Tensor) else a)
            for a in (tree_leaves(tree) if not isinstance(tree, list)
                      else tree)]


def _assert_leaves(got, want, **tol):
    g, w = _leaves_np(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


METHODS = [
    ("SGD", lambda o: o.SGD(0.1)),
    ("SGD momentum wd", lambda o: o.SGD(0.1, 0.01, weight_decay=1e-2,
                                        momentum=0.9)),
    ("SGD nesterov", lambda o: o.SGD(0.1, momentum=0.9, dampening=0.0,
                                     nesterov=True)),
    ("Adam", lambda o: o.Adam(0.01, 0.05)),
    ("AdamWeightDecay", lambda o: o.AdamWeightDecay(
        0.01, warmup_portion=0.4, total=5)),
    ("Adagrad", lambda o: o.Adagrad(0.1, weight_decay=0.01)),
    ("RMSprop", lambda o: o.RMSprop(0.01)),
    ("Adadelta", lambda o: o.Adadelta()),
    ("Adamax", lambda o: o.Adamax()),
    ("Ftrl", lambda o: o.Ftrl(0.1, l1_regularization_strength=0.01,
                              l2_regularization_strength=0.1)),
    ("LBFGS", lambda o: o.LBFGS(0.5, history_size=3)),
    ("ParallelAdam", lambda o: o.ParallelAdam(0.02)),
]


@pytest.mark.parametrize("case", METHODS, ids=[c[0] for c in METHODS])
def test_optim_method_five_steps(case):
    name, build = case
    rs = np.random.RandomState(0)
    tree = {"a": {"weight": rs.randn(3, 4).astype(np.float32)},
            "bias": rs.randn(4).astype(np.float32)}
    jm, tm = build(jom), build(tom)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tree_map(torch.from_numpy, tree)
    js, ts = jm.init_state(jp), tm.init_state(tp)
    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda a: rs.randn(*a.shape).astype(np.float32), tree)
        lr = jm.current_lr()
        assert tm.current_lr() == pytest.approx(lr, rel=1e-12)
        jp, js = jm.step(jp, jax.tree_util.tree_map(jnp.asarray, g), js, lr)
        tp, ts = tm.step(tp, tree_map(torch.from_numpy, g), ts, lr)
        for m in (jm, tm):
            m.host_state["eval_counter"] += 1
        _assert_leaves(tp, jp, rtol=1e-5, atol=1e-6)
        _assert_leaves(ts, js, rtol=1e-5, atol=1e-6)


SCHEDULES = [
    ("Default", lambda o: o.Default(), dict(learning_rate_decay=0.1)),
    ("Step", lambda o: o.Step(3, 0.5), {}),
    ("MultiStep", lambda o: o.MultiStep([2, 5], 0.1), {}),
    ("Exponential", lambda o: o.Exponential(4, 0.5), {}),
    ("Exponential stair", lambda o: o.Exponential(4, 0.5, True), {}),
    ("Poly", lambda o: o.Poly(2.0, 6), {}),
    ("Warmup", lambda o: o.Warmup(0.01), {}),
    ("Sequential", lambda o: o.SequentialSchedule().add(
        o.Warmup(0.1), 3).add(o.Step(2, 0.5), 10), {}),
]


@pytest.mark.parametrize("case", SCHEDULES, ids=[c[0] for c in SCHEDULES])
def test_schedule(case):
    name, build, kw = case
    js, ts = build(joptim), build(toptim)
    for n in range(9):
        st = dict(eval_counter=n, **kw)
        assert ts.lr(0.1, st) == js.lr(0.1, st)


def test_plateau_schedule():
    jp, tp = joptim.Plateau(patience=2, factor=0.5, cooldown=1), \
        toptim.Plateau(patience=2, factor=0.5, cooldown=1)
    for s in (1.0, 0.9, 0.95, 0.93, 0.92, 0.99, 0.99, 0.99, 0.5):
        jp.record_score(s)
        tp.record_score(s)
        assert tp.lr(0.1, {}) == jp.lr(0.1, {})


VALIDATIONS = [("Top1Accuracy", lambda o: o.Top1Accuracy()),
               ("Top5Accuracy", lambda o: o.Top5Accuracy()),
               ("Top1 zero-based", lambda o: o.Top1Accuracy(True)),
               ("MAE", lambda o: o.MAE()),
               ("HitRatio", lambda o: o.HitRatio(3)),
               ("NDCG", lambda o: o.NDCG(3))]


@pytest.mark.parametrize("case", VALIDATIONS, ids=[c[0] for c in VALIDATIONS])
def test_validation_method(case):
    name, build = case
    rs = np.random.RandomState(2)
    out = rs.randn(16, 10).astype(np.float32)
    tgt = out + 0.1 if name == "MAE" else (
        rs.randint(0, 10, 16) + 1).astype(np.float32)
    j = build(joptim)(jnp.asarray(out), jnp.asarray(tgt))
    t = build(toptim)(torch.from_numpy(out), torch.from_numpy(tgt))
    assert (t.sum_value, t.count) == pytest.approx((j.sum_value, j.count))


def test_loss_validation_and_triggers():
    rs = np.random.RandomState(3)
    out = np.log(np.full((8, 4), 0.25, np.float32)) + rs.rand(8, 4) * 0.1
    tgt = (rs.randint(0, 4, 8) + 1).astype(np.float32)
    j = joptim.Loss()(jnp.asarray(out, jnp.float32), jnp.asarray(tgt))
    t = toptim.Loss()(torch.from_numpy(out.astype(np.float32)),
                      torch.from_numpy(tgt))
    assert t.result == pytest.approx(j.result, rel=1e-6)
    make = [lambda T: T.every_epoch(), lambda T: T.several_iteration(3),
            lambda T: T.max_epoch(2), lambda T: T.max_iteration(5),
            lambda T: T.min_loss(0.5), lambda T: T.max_score(0.8),
            lambda T: T.or_(T.max_iteration(4), T.min_loss(0.1)),
            lambda T: T.and_(T.several_iteration(2), T.max_epoch(1))]
    for mk in make:
        jt, tt = mk(joptim.Trigger), mk(toptim.Trigger)
        assert tt.uses_loss == jt.uses_loss
        for i in range(8):
            st = {"epoch": 1 + i // 3, "neval": i + 1, "iteration_done": i,
                  "loss": 1.0 / (i + 1), "score": i / 8,
                  "epoch_finished": i % 3 == 2}
            assert tt(dict(st)) == jt(dict(st)), (i, st)


def test_summary_reads_back_and_reaches_registry(tmp_path):
    from bigdl_tpu_torch import observability as obs
    was = obs.enabled()
    obs.enable()
    try:
        s = toptim.TrainSummary(str(tmp_path), "app")
        s.add_scalar("Loss", 0.5, 1)
        s.add_scalar("Loss", 0.25, 2)
        assert s.read_scalar("Loss") == [(1, 0.5), (2, 0.25)]
        s.close()
        assert 'bigdl_summary_scalar{app="app",kind="train",tag="Loss"} ' \
            '0.25' in obs.render()
    finally:
        if not was:
            obs.disable()


def test_distributed_pieces_build():
    """``DistributedDataSet`` without a rank, ``Optimizer(distributed=
    True)`` and ``DistriOptimizer`` build (on the CPU, over a gloo world
    of one); the facade's default picks the local optimizer at world 1;
    with the elastic plane on, the distributed optimizer trains and takes
    its ring snapshots at the cadence."""
    from bigdl_tpu_torch.utils.conf import conf
    from bigdl_tpu_torch.utils.engine import Engine
    x, y = np.zeros((8, 2), np.float32), np.ones((8, 2), np.float32)
    ds = DistributedDataSet(x, y)
    assert (ds.rank, ds.world) == (0, 1) and len(list(ds.data())) == 8
    ds = DistributedDataSet(np.arange(8), shuffle=False, rank=1, world=2)
    assert [int(s.feature()) for s in ds.data()] == [1, 3, 5, 7]
    m = tnn.Linear(2, 2)
    Engine.reset()
    try:
        opt = toptim.Optimizer(m, (x, y), tnn.MSECriterion(), 4,
                               distributed=True, device="cpu")
        assert type(opt) is toptim.DistriOptimizer
        assert Engine.world_size() == 1 and opt.mesh.shape == (1,)
        assert type(toptim.Optimizer(m, (x, y), tnn.MSECriterion(),
                                     device="cpu")) is toptim.LocalOptimizer
        opt = toptim.DistriOptimizer(m, (x, y), tnn.MSECriterion(), 4,
                                     device="cpu")
        conf.set("bigdl.elastic.enabled", "true")
        conf.set("bigdl.elastic.snapshot.every", "1")
        try:
            opt.optimize()
            assert opt.state["iteration_done"] == 2
            assert opt._elastic.ring.taken == 2
            assert opt._elastic.ring.newest_committed().step == 3
        finally:
            conf.unset("bigdl.elastic.enabled")
            conf.unset("bigdl.elastic.snapshot.every")
    finally:
        Engine.reset()


# -- LocalOptimizer -------------------------------------------------------------

def _lenets():
    jm = jlenet.build_model(10)
    tm = tlenet.build_model(10, device="cpu")
    tm.load_parameters_dict(jax.tree_util.tree_map(np.asarray,
                                                   jm.parameters_dict()))
    return jm, tm


def test_lenet_twenty_iterations_match_jax(tmp_path):
    """20 Adam iterations at batch 32 over one shuffled epoch of 640
    synthetic digits: the drained losses and the final weights agree
    with the JAX run within 2e-4."""
    x, y = jload_mnist(synthetic_size=640)
    x = normalize(x)
    np.testing.assert_array_equal(load_mnist(synthetic_size=640)[1], y)
    jm, tm = _lenets()
    runs = []
    for o, m, ds in ((joptim, jm, JLocalDataSet(x, y, seed=5)),
                     (toptim, tm, LocalDataSet(x, y, seed=5))):
        kw = {} if o is joptim else {"device": "cpu"}
        opt = o.LocalOptimizer(m, ds, (jnn if o is joptim else tnn)
                               .ClassNLLCriterion(), batch_size=32,
                               end_trigger=o.Trigger.max_iteration(20), **kw)
        opt.set_optim_method(o.Adam(learning_rate=0.003))
        summ = o.TrainSummary(str(tmp_path / o.__name__), "lenet",
                              flush_every=1)
        opt.set_train_summary(summ)
        runs.append((opt.optimize(), summ.read_scalar("Loss")))
    (jt, jloss), (tt, tloss) = runs
    assert [s for s, _ in tloss] == [s for s, _ in jloss] == \
        list(range(1, 21))
    np.testing.assert_allclose([v for _, v in tloss], [v for _, v in jloss],
                               rtol=2e-4, atol=2e-4)
    assert tloss[-1][1] < tloss[0][1]
    _assert_leaves(tt.parameters_dict(), jt.parameters_dict(), rtol=2e-4,
                   atol=2e-4)
    ev = toptim.Evaluator(tt, device="cpu").evaluate(
        (x[:100], y[:100]), [toptim.Top1Accuracy()], 50)[0]
    jev = joptim.Evaluator(jt).evaluate(
        (x[:100], y[:100]), [joptim.Top1Accuracy()], 50)[0]
    assert ev.result == pytest.approx(jev.result, abs=0.02)
    pred = toptim.Predictor(tt, 64, device="cpu").predict_class(x[:70])
    assert pred.shape == (70,) and pred.min() >= 1


def _mlp(o, nn, seed=0):
    from bigdl_tpu.nn.module import set_seed
    set_seed(seed)
    jm = (jnn.Sequential().add(jnn.Linear(8, 16)).add(jnn.Tanh())
          .add(jnn.Linear(16, 4)).add(jnn.LogSoftMax()))
    tm = (tnn.Sequential().add(tnn.Linear(8, 16)).add(tnn.Tanh())
          .add(tnn.Linear(16, 4)).add(tnn.LogSoftMax()))
    tm.load_parameters_dict(jax.tree_util.tree_map(np.asarray,
                                                   jm.parameters_dict()))
    return jm, tm


def _toy(n=64):
    rs = np.random.RandomState(0)
    return (rs.randn(n, 8).astype(np.float32),
            (rs.randint(0, 4, n) + 1).astype(np.float32))


@pytest.mark.parametrize("clip", ["constant", "l2"])
def test_gradient_clipping_matches_jax(clip):
    x, y = _toy()
    jm, tm = _mlp(joptim, jnn)
    out = []
    for o, nn, m in ((joptim, jnn, jm), (toptim, tnn, tm)):
        kw = {} if o is joptim else {"device": "cpu"}
        opt = o.LocalOptimizer(m, (x, y), nn.ClassNLLCriterion(), 16,
                               o.Trigger.max_iteration(6), **kw)
        opt.set_optim_method(o.SGD(0.5, momentum=0.5))
        if clip == "constant":
            opt.set_constant_gradient_clipping(-0.02, 0.02)
        else:
            opt.set_gradient_clipping_by_l2_norm(0.05)
        out.append(opt.optimize())
    _assert_leaves(out[1].parameters_dict(), out[0].parameters_dict(),
                   rtol=1e-5, atol=1e-6)


def _port_run(tmp_path, name, epochs, ds=None, model=None, retry=0,
              ckpt=True):
    x, y = _toy()
    tm = model if model is not None else _mlp(joptim, jnn)[1]
    opt = toptim.LocalOptimizer(tm, ds or LocalDataSet(x, y, seed=1),
                                tnn.ClassNLLCriterion(), 16,
                                toptim.Trigger.max_epoch(epochs),
                                device="cpu")
    opt.set_optim_method(toptim.Adam(0.01))
    if ckpt:
        opt.set_checkpoint(str(tmp_path / name), toptim.Trigger.every_epoch())
    if retry:
        opt.set_max_retry(retry)
    return opt


def _weights(m):
    return [p.detach().clone() for p in tree_leaves(m.parameters_dict())]


def _same(a, b):
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_resume_equals_uninterrupted(tmp_path):
    """A run stopped after epoch 2 and resumed (a fresh optimizer and
    model auto-resume from the checkpoint directory; the dataset object
    carries on) ends bit-equal to the uninterrupted 4-epoch run."""
    full = _port_run(tmp_path, "full", 4).optimize()
    x, y = _toy()
    ds = LocalDataSet(x, y, seed=1)
    _port_run(tmp_path, "cut", 2, ds=ds).optimize()
    tag = tckpt.latest(str(tmp_path / "cut"), paired_prefix="model.")
    assert tag == "3.9"
    fresh = _mlp(joptim, jnn, seed=9)[1]
    opt = _port_run(tmp_path, "cut", 4, ds=ds, model=fresh)
    assert reliability.enabled()
    resumed = opt.optimize()
    assert opt.state["neval"] == 17 and resumed is fresh
    _same(_weights(resumed), _weights(full))


def test_max_retry_replays_after_injected_fault(tmp_path):
    x, y = _toy()
    clean = _port_run(tmp_path, "clean", 3,
                      ds=LocalDataSet(x, y, shuffle=False)).optimize()
    opt = _port_run(tmp_path, "flaky", 3, ds=LocalDataSet(x, y,
                                                          shuffle=False),
                    retry=1)
    plan = reliability.FaultPlan().add("optimizer.step", "raise", after=6)
    reliability.set_plan(plan)
    try:
        trained = opt.optimize()
    finally:
        reliability.set_plan(None)
    assert plan.fired == [("optimizer.step", "raise")]
    _same(_weights(trained), _weights(clean))
    opt = _port_run(tmp_path, "none", 1, ckpt=False, retry=1)
    opt._place_batch = lambda *a: (_ for _ in ()).throw(
        RuntimeError("permanent failure"))
    with pytest.raises(RuntimeError, match="permanent failure"):
        opt.optimize()


def test_preemption_checkpoints_and_resumes_exactly(tmp_path):
    x, y = _toy()
    ds = LocalDataSet(x, y, shuffle=False)
    opt = _port_run(tmp_path, "p", 3, ds=ds)
    hits = {"n": 0}
    orig = opt._check_preemption

    def hook(opt_state, state):
        hits["n"] += 1
        if hits["n"] == 6:      # what the SIGTERM handler does
            opt._preempt_requested = True
        return orig(opt_state, state)

    opt._check_preemption = hook
    with pytest.raises(reliability.TrainingPreempted):
        opt.optimize()
    assert opt.state["neval"] == 7
    saved = _weights(opt.model)
    again = _port_run(tmp_path, "p", 3, ds=ds,
                      model=_mlp(joptim, jnn, seed=4)[1])
    seen = {}
    once = again._optimize_once

    def capture():
        seen["neval"], seen["w"] = again.state["neval"], _weights(again.model)
        return once()

    again._optimize_once = capture
    again.optimize()
    assert seen["neval"] == 7 and again.state["epoch"] == 4
    _same(seen["w"], saved)
    clean = _port_run(tmp_path, "c", 3, ds=LocalDataSet(x, y, shuffle=False))
    _same(_weights(again.model), _weights(clean.optimize()))


def test_train_series_match_the_jax_names():
    """The trainer's ``bigdl_train_*`` series are the JAX package's, and
    count what ran (2 steps of 16 examples)."""
    from bigdl_tpu.optim.optimizer import _train_instruments as jins
    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.optim.optimizer import _train_instruments as tins
    was = obs.enabled()
    obs.enable()
    try:
        assert sorted(m.name for m in tins().values()) == \
            sorted(m.name for m in jins().values())
        x, y = _toy(32)
        before = obs.render()
        toptim.LocalOptimizer(_mlp(joptim, jnn)[1], (x, y),
                              tnn.ClassNLLCriterion(), 16,
                              toptim.Trigger.max_iteration(2),
                              device="cpu").optimize()
        after = {l.split(" ")[0]: float(l.split(" ")[1])
                 for l in obs.render().splitlines()
                 if l.startswith(("bigdl_train_steps_total",
                                  "bigdl_train_examples_total"))}
        old = {l.split(" ")[0]: float(l.split(" ")[1])
               for l in before.splitlines()
               if l.startswith(tuple(after))}
        assert after["bigdl_train_steps_total"] - old.get(
            "bigdl_train_steps_total", 0) == 2
        assert after["bigdl_train_examples_total"] - old.get(
            "bigdl_train_examples_total", 0) == 32
    finally:
        if not was:
            obs.disable()

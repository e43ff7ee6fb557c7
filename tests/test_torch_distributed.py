"""The port's data-parallel training held to the JAX package on the CPU.

Two gloo ranks are started once for the module (one ``python -c``
script a rank, importing only ``torch`` and ``bigdl_tpu_torch``; the
port of rank 0's store is bound at ``127.0.0.1:0`` and handed to rank 1
through a file). They read their inputs and the JAX models' initial
weights from an ``.npz`` made here with numpy from a seed, and write
what they compute to one ``.npz`` a rank; the comparisons run here,
against the JAX package on a 2-device CPU mesh (``create_mesh({"data":
2})``):

- (a) each collective against the JAX one under ``shard_map``: the plain
  all-reduce within f32 order (rtol 1e-6), the bf16 wire equal to JAX's
  bf16 sum, the int8 all-reduce within one shared quantisation step of
  JAX's, the data movers exact;
- (b) ``DistriOptimizer`` at W = 2 against the JAX ``DistriOptimizer``
  on the same global batches and weights, for an MLP and a conv + batch
  norm net, in modes None, bf16 and int8: per-step losses, final weights
  and the batch-norm running statistics, within ``TOLS[mode]`` (plain
  f32: reduction order only; bf16 / int8: a gradient element that rounds
  across a wire step moves by that step, lr x momentum amplified over the
  run; the JAX int8 step also quantizes the summed gradient once, where
  each rank quantizes its own here), the JAX compressed runs at lr / 2
  (see ``_jax_train``); ``dp_train_step`` likewise;
- (c) at W = 1 ``DistriOptimizer`` equals ``LocalOptimizer`` bit for
  bit in plain mode;
- (d) Keras ``fit`` with its defaults against the JAX ``fit`` with its
  defaults;
- (e) ``DistributedDataSet`` takes its rank and world from the group;
- (f) a checkpoint saved at W = 2 is refused at W = 1;
- the Engine's failure contract (an unreachable explicit coordinator
  raises; the launch variables warn, count and go on alone; no NCCL
  without a card), the collectives' counters, and the allocator's split
  limit that resolving the GPU sets.

The ranks have their own 120 s limit: past it the test fails."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import bigdl_tpu.keras as JK
import bigdl_tpu.nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu import parallel as jpar
from bigdl_tpu.nn.module import set_seed as jset_seed
from bigdl_tpu.utils.jax_compat import shard_map

import bigdl_tpu_torch.keras as TK
import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch import observability as tobs
from bigdl_tpu_torch.feature.dataset import DistributedDataSet
from bigdl_tpu_torch.utils import checkpoint as tckpt
from bigdl_tpu_torch.utils.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("none", "bf16", "int8")
STEPS, BATCH = 5, 8
# per mode: (losses rtol, weights and statistics atol); read on a CPU:
# plain 1.6e-7 / 6e-8, bf16 1.0e-4 / 2.2e-4, int8 2.7e-4 / 4.6e-4
TOLS = {"none": (1e-6, 1e-6), "bf16": (1e-3, 2e-3), "int8": (1e-3, 2e-3)}

# the two nets, built alike in either package's ``nn``
NETS = '''
def build(nn, kind):
    if kind == "mlp":
        return (nn.Sequential().add(nn.Linear(6, 16)).add(nn.Tanh())
                .add(nn.Linear(16, 4)).add(nn.LogSoftMax()))
    return (nn.Sequential().add(nn.SpatialConvolution(2, 4, 3, 3, 1, 1, 1, 1))
            .add(nn.SpatialBatchNormalization(4)).add(nn.ReLU())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2)).add(nn.Reshape([64]))
            .add(nn.Linear(64, 3)).add(nn.LogSoftMax()))


def tree(flat, prefix):
    out = {}
    for k in flat.files:
        if k.startswith(prefix + "/"):
            node = out
            *path, leaf = k[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = flat[k]
    return out
'''

RANK = NETS + r'''
import datetime, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, work = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
wait = datetime.timedelta(seconds=60)
portfile = os.path.join(work, "port")
if rank == 0:
    store = dist.TCPStore("127.0.0.1", 0, 2, True, timeout=wait,
                          wait_for_workers=False)
    with open(portfile + ".tmp", "w") as f:
        f.write(str(store.port))
    os.replace(portfile + ".tmp", portfile)
else:
    t0 = time.time()
    while not os.path.exists(portfile):
        if time.time() - t0 > 60:
            raise SystemExit("rank 0 gave no port")
        time.sleep(0.02)
    store = dist.TCPStore("127.0.0.1", int(open(portfile).read()), 2, False,
                          timeout=wait)
dist.init_process_group("gloo", store=store, rank=rank, world_size=2)

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch import observability as obs, optim
from bigdl_tpu_torch.feature.dataset import DistributedDataSet
from bigdl_tpu_torch.parallel import (
    all_gather, all_reduce, all_to_all, barrier_sum, compressed_all_reduce,
    create_mesh, dp_train_step, mesh_axis_size, ppermute_next,
    quantized_all_reduce, reduce_scatter, shard_batch)
from bigdl_tpu_torch.utils.engine import Engine

mesh = Engine.init(engine_type="cpu")
inp = np.load(os.path.join(work, "inputs.npz"))
out = {}
t = lambda k: torch.from_numpy(inp[k][rank])
tr = {"a": t("c_a"), "b": t("c_b")}
grp = Engine.data_group()
for name, fn in [
        ("ar_sum", lambda: all_reduce(tr, "data")),
        ("ar_mean", lambda: all_reduce(tr, grp, mean=True)),
        ("bf16_sum", lambda: compressed_all_reduce(tr, "data")),
        ("bf16_mean", lambda: compressed_all_reduce(tr, grp, mean=True)),
        ("q_sum", lambda: quantized_all_reduce(tr, "data")),
        ("q_mean", lambda: quantized_all_reduce(tr, grp, mean=True))]:
    res = fn()
    for k in ("a", "b"):
        out[f"{name}/{k}"] = res[k].numpy()
s = t("c_s")
for name, fn in [
        ("ag0", lambda: all_gather(s, "data")),
        ("ag1", lambda: all_gather(s, grp, axis=1)),
        ("ag_stack", lambda: all_gather(s, "data", axis=1, tiled=False)),
        ("rs0", lambda: reduce_scatter(s, "data")),
        ("rs1", lambda: reduce_scatter(s, grp, axis=1)),
        ("a2a", lambda: all_to_all(s, "data", split_axis=0, concat_axis=1)),
        ("pp", lambda: ppermute_next(s, grp)),
        ("barrier", lambda: barrier_sum("data"))]:
    out[name] = fn().numpy()
out["metrics"] = np.array(obs.render())
for name, axes in (("absorb", {"data": -1}), ("names", ["data", "model"]),
                   ("two", {"model": 1, "data": 2})):
    m = create_mesh(axes)
    out[f"mesh/{name}"] = np.array(
        [mesh_axis_size(m, a) for a in ("data", "model", "seq")])


def steps_of(opt):
    losses, drain = [], opt._drain_loss

    def tracked():
        pending = opt._pending_loss
        drain()
        if pending is not None:
            losses.append(opt.state["loss"])
    opt._drain_loss = tracked
    return losses


for kind in ("mlp", "conv"):
    for mode in ("none", "bf16", "int8"):
        m = build(nn, kind)
        m.load_parameters_dict(tree(inp, f"p_{kind}"))
        m.load_states_dict(tree(inp, f"s_{kind}"))
        opt = optim.DistriOptimizer(
            m, (inp[f"x_{kind}"], inp[f"y_{kind}"]), nn.ClassNLLCriterion(),
            8, optim.Trigger.max_iteration(5), device="cpu")
        opt.set_gradient_compression(None if mode == "none" else mode)
        opt.set_optim_method(optim.SGD(0.1, momentum=0.9))
        losses = steps_of(opt)
        opt.optimize()
        key = f"{kind}_{mode}"
        out[f"{key}/losses"] = np.array(losses)
        for group, d in (("p", m.parameters_dict()), ("s", m.states_dict())):
            for name, sub in d.items():
                for leaf, v in sub.items():
                    out[f"{key}/{group}/{name}/{leaf}"] = v.detach().numpy()

p = {k: torch.from_numpy(inp[f"dp/{k}"]) for k in ("w1", "b1", "w2", "b2")}


def apply_fn(p, s, x, rng):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return torch.log_softmax(h @ p["w2"] + p["b2"], -1), s


sgd = optim.SGD(0.1)
step = dp_train_step(apply_fn, nn.ClassNLLCriterion().apply_loss, sgd, mesh)
xs, ys = shard_batch([torch.from_numpy(inp["x_mlp"][:8]),
                      torch.from_numpy(inp["y_mlp"][:8])], mesh)
new, _, _, loss = step(p, {}, sgd.init_state(p), xs, ys, sgd.current_lr())
out.update({f"dp/{k}": v.numpy() for k, v in new.items()})
out["dp/loss"] = loss.numpy()

out["dds"] = np.array([float(s.feature()) for s in DistributedDataSet(
    np.arange(10, dtype=np.float32), shuffle=False).data()])
m = build(nn, "mlp")
out["facade"] = np.array(type(optim.Optimizer(
    m, (inp["x_mlp"], inp["y_mlp"]), nn.ClassNLLCriterion(), 8,
    device="cpu")).__name__)
opt = optim.DistriOptimizer(m, (inp["x_mlp"], inp["y_mlp"]),
                            nn.ClassNLLCriterion(), 8,
                            optim.Trigger.max_iteration(2), device="cpu")
opt.set_checkpoint(os.path.join(work, "ckpt"),
                   optim.Trigger.several_iteration(2))
opt.optimize()
np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
Engine.reset()
assert not dist.is_initialized()
'''


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _nets():
    ns = {}
    exec(NETS, ns)
    return ns


def _data(kind, rs):
    if kind == "mlp":
        x = rs.randn(32, 6).astype(np.float32)
        return x, ((x @ rs.randn(6, 4)).argmax(1) + 1).astype(np.float32)
    x = rs.randn(32, 2, 8, 8).astype(np.float32)
    return x, (rs.randint(0, 3, 32) + 1).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs and the JAX models' initial weights, the two gloo ranks
    run once on them, and what each wrote."""
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    work = str(tmp_path_factory.mktemp("gloo"))
    rs = np.random.RandomState(0)
    inp = {"c_a": rs.randn(2, 5, 7).astype(np.float32),
           "c_b": (rs.randn(2, 600) * np.linspace(0.01, 10, 600)).astype(
               np.float32),
           "c_s": rs.randn(2, 4, 6).astype(np.float32)}
    build = _nets()["build"]
    init = {}
    try:
        for kind in ("mlp", "conv"):
            jset_seed(7)
            jm = build(jnn, kind)
            init[kind] = (jax.tree_util.tree_map(np.asarray,
                                                 jm.parameters_dict()),
                          jax.tree_util.tree_map(np.asarray,
                                                 jm.states_dict()))
            _flat(init[kind][0], f"p_{kind}", inp)
            _flat(init[kind][1], f"s_{kind}", inp)
            inp[f"x_{kind}"], inp[f"y_{kind}"] = _data(kind, rs)
    finally:
        RNG._key, FORWARD_RNG._key = keys
    for k, shape in (("w1", (6, 8)), ("b1", (8,)), ("w2", (8, 4)),
                     ("b2", (4,))):
        inp[f"dp/{k}"] = (0.5 * rs.randn(*shape)).astype(np.float32)
    np.savez(os.path.join(work, "inputs.npz"), **inp)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK", "BIGDL_TPU_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), work],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for r in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            errs.append(err)
    except subprocess.TimeoutExpired:
        pytest.fail("the gloo ranks did not finish within 120 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{errs[r][-4000:]}"
    outs = [dict(np.load(os.path.join(work, f"out_{r}.npz")))
            for r in range(2)]
    return {"inp": inp, "init": init, "outs": outs, "work": work}


@pytest.fixture
def engine():
    """A cold Engine before and after (the port's and JAX's)."""
    Engine.reset()
    yield Engine
    Engine.reset()


def _q_step(x):
    """The shared scale of each 256-element block of ``x``'s leaves,
    element by element: |x_0| and |x_1|'s block max over 127."""
    out = {}
    for k, v in x.items():
        flat = np.abs(v).reshape(2, -1)
        pad = (-flat.shape[1]) % 256
        flat = np.pad(flat, ((0, 0), (0, pad))).reshape(2, -1, 256)
        s = np.repeat(flat.max(axis=(0, 2)) / 127.0, 256)
        out[k] = s[:v[0].size].reshape(v.shape[1:])
    return out


COLLECTIVES = [
    ("ar_sum", lambda t: jpar.all_reduce(t, "data")),
    ("ar_mean", lambda t: jpar.all_reduce(t, "data", mean=True)),
    ("bf16_sum", lambda t: jpar.compressed_all_reduce(t, "data")),
    ("bf16_mean", lambda t: jpar.compressed_all_reduce(t, "data", mean=True)),
    ("q_sum", lambda t: jpar.quantized_all_reduce(t, "data")),
    ("q_mean", lambda t: jpar.quantized_all_reduce(t, "data", mean=True)),
    ("ag0", lambda s: jpar.all_gather(s, "data")),
    ("ag1", lambda s: jpar.all_gather(s, "data", axis=1)),
    ("ag_stack", lambda s: jpar.all_gather(s, "data", axis=1, tiled=False)),
    ("rs0", lambda s: jpar.reduce_scatter(s, "data")),
    ("rs1", lambda s: jpar.reduce_scatter(s, "data", axis=1)),
    ("a2a", lambda s: jpar.all_to_all(s, "data", 0, 1)),
    ("pp", lambda s: jpar.ppermute_next(s, "data")),
    ("barrier", lambda s: jpar.barrier_sum("data")),
]


@pytest.fixture(scope="module")
def jax_collectives(ranks):
    """Every JAX collective of ``COLLECTIVES`` in one ``shard_map`` over
    the 2-device mesh, each device holding its rank's inputs."""
    inp = ranks["inp"]
    x = {"t": {"a": inp["c_a"], "b": inp["c_b"]}, "s": inp["c_s"]}

    def body(v):
        v = jax.tree_util.tree_map(lambda y: y[0], v)
        res = {name: fn(v["t"] if _is_tree(name) else v["s"])
               for name, fn in COLLECTIVES}
        return jax.tree_util.tree_map(lambda y: y[None], res)

    f = shard_map(body, mesh=jpar.create_mesh({"data": 2}),
                  in_specs=P("data"), out_specs=P("data"))
    return jax.tree_util.tree_map(np.asarray, jax.jit(f)(
        jax.tree_util.tree_map(jnp.asarray, x)))


def _is_tree(name):
    return name[:2] in ("ar", "bf", "q_")


@pytest.mark.parametrize("case", COLLECTIVES, ids=[c[0] for c in COLLECTIVES])
def test_collective_matches_jax(ranks, jax_collectives, case):
    name = case[0]
    inp, outs, want = ranks["inp"], ranks["outs"], jax_collectives[name]
    x = {"a": inp["c_a"], "b": inp["c_b"]}
    for r in range(2):
        if not _is_tree(name):
            np.testing.assert_allclose(outs[r][name], want[r], rtol=1e-6,
                                       atol=0, err_msg=f"{name} rank {r}")
            continue
        step = _q_step(x)
        for k in ("a", "b"):
            got, w = outs[r][f"{name}/{k}"], want[k][r]
            assert got.dtype == w.dtype == np.float32, (name, got.dtype)
            if name.startswith("bf16"):
                np.testing.assert_array_equal(got, w, err_msg=name)
            elif name.startswith("q_"):
                lim = step[k] / (2 if name == "q_mean" else 1)
                assert (np.abs(got - w) <= lim).all(), (name, k)
                assert (np.abs(got - x[k].sum(0) / (
                    2 if name == "q_mean" else 1)) <= lim + 1e-6).all()
            else:
                np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} {k}")


def test_collective_counters(ranks):
    """Each executed call bumps its ``op`` series, at the JAX package's
    byte rates (f32 4 B; the bf16 wire 2 B; int8 1 + 4 / 256 B)."""
    text = str(ranks["outs"][0]["metrics"])

    def read(series, op):
        m = re.search(rf'^{series}{{op="{op}"}} (\S+)$', text, re.M)
        return float(m.group(1)) if m else None

    n = 5 * 7 + 600
    for op, calls, nbytes in (("all_reduce", 2, 2 * 4 * n),
                              ("compressed_all_reduce", 2, 2 * 2 * n),
                              ("quantized_all_reduce", 2,
                               2 * (int(35 * (1 + 4 / 256))
                                    + int(600 * (1 + 4 / 256)))),
                              ("all_gather", 3, 3 * 96),
                              ("reduce_scatter", 2, 2 * 96),
                              ("all_to_all", 1, 96), ("ppermute", 1, 96)):
        assert read("bigdl_collective_calls_total", op) == calls, op
        assert read("bigdl_collective_traced_bytes_total", op) == nbytes, op


def _jax_train(kind, mode, init, x, y):
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    try:
        jm = _nets()["build"](jnn, kind)
    finally:
        RNG._key, FORWARD_RNG._key = keys
    jm.load_parameters_dict(jax.tree_util.tree_map(jnp.asarray, init[0]))
    jm.load_states_dict(jax.tree_util.tree_map(jnp.asarray, init[1]))
    opt = joptim.DistriOptimizer(jm, (x, y), jnn.ClassNLLCriterion(), BATCH,
                                 joptim.Trigger.max_iteration(STEPS),
                                 mesh=jpar.create_mesh({"data": 2}))
    opt.set_gradient_compression(None if mode == "none" else mode)
    # The JAX compressed step applies W x the mean gradient under this
    # JAX (its shard_map transpose already sums the replicated params'
    # gradient over the axis; compressed_all_reduce then sums again and
    # divides by W). SGD's update is linear in lr x gradient (momentum,
    # no weight decay), so the reference at lr / W is the mean-gradient
    # run the port makes.
    opt.set_optim_method(joptim.SGD(0.1 if mode == "none" else 0.1 / 2,
                                    momentum=0.9))
    losses, drain = [], opt._drain_loss

    def tracked():
        pending = opt._pending_loss
        drain()
        if pending is not None:
            losses.append(opt.state["loss"])
    opt._drain_loss = tracked
    opt.optimize()
    return losses, _flat(jax.tree_util.tree_map(
        np.asarray, jm.parameters_dict()), "p", {}), _flat(
        jax.tree_util.tree_map(np.asarray, jm.states_dict()), "s", {})


RUNS = [(k, m) for k in ("mlp", "conv") for m in MODES]


@pytest.mark.parametrize("run", RUNS, ids=[f"{k}-{m}" for k, m in RUNS])
def test_distri_optimizer_matches_jax(ranks, run):
    kind, mode = run
    inp, outs = ranks["inp"], ranks["outs"]
    losses, params, states = _jax_train(kind, mode, ranks["init"][kind],
                                        inp[f"x_{kind}"], inp[f"y_{kind}"])
    key = f"{kind}_{mode}"
    rtol, atol = TOLS[mode]
    # both ranks hold the same model: they applied the same update
    for k in outs[0]:
        if k.startswith(key + "/"):
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)
    got = outs[0]
    assert len(losses) == STEPS
    np.testing.assert_allclose(got[f"{key}/losses"], losses, rtol=rtol,
                               err_msg=f"{key} losses")
    want = {**params, **states}
    assert kind == "mlp" or "s/1/running_var" in want
    for k, v in want.items():
        np.testing.assert_allclose(got[f"{key}/{k}"], v, rtol=0, atol=atol,
                                   err_msg=f"{key} {k}")


def test_dp_train_step_matches_jax(ranks):
    inp, outs = ranks["inp"], ranks["outs"]
    p = {k: jnp.asarray(inp[f"dp/{k}"]) for k in ("w1", "b1", "w2", "b2")}

    def apply_fn(p, s, x, rng):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return jax.nn.log_softmax(h @ p["w2"] + p["b2"], -1), s

    sgd = joptim.SGD(0.1)
    step = jpar.dp_train_step(apply_fn, jnn.ClassNLLCriterion().apply_loss,
                              sgd, jpar.create_mesh({"data": 2}),
                              donate=False)
    new, _, _, loss = step(p, {}, sgd.init_state(p),
                           jnp.asarray(inp["x_mlp"][:8]),
                           jnp.asarray(inp["y_mlp"][:8]),
                           sgd.current_lr(), None)
    for r in range(2):
        for k, v in new.items():
            np.testing.assert_allclose(outs[r][f"dp/{k}"], np.asarray(v),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(outs[r]["dp/loss"], float(loss),
                                   rtol=1e-6)


MESHES = [("absorb", {"data": -1}), ("names", ["data", "model"]),
          ("two", {"model": 1, "data": 2})]


@pytest.mark.parametrize("case", MESHES, ids=[c[0] for c in MESHES])
def test_create_mesh_matches_jax(ranks, case):
    """The port's mesh over two ranks has the JAX mesh's axis sizes over
    two devices."""
    name, axes = case
    want = jpar.create_mesh(axes, devices=jax.devices()[:2])
    for r in range(2):
        np.testing.assert_array_equal(
            ranks["outs"][r][f"mesh/{name}"],
            [jpar.mesh_axis_size(want, a) for a in ("data", "model", "seq")])


def test_distributed_dataset_and_facade_from_the_group(ranks):
    outs = ranks["outs"]
    for r in range(2):
        np.testing.assert_array_equal(outs[r]["dds"], np.arange(r, 10, 2))
        assert str(outs[r]["facade"]) == "DistriOptimizer"
    # without a group: rank 0 of a world of one, as jax.process_index is
    assert not dist.is_initialized()
    ds = DistributedDataSet(np.arange(4, dtype=np.float32), shuffle=False)
    assert (ds.rank, ds.world) == (0, 1)


def _conv_model(ranks):
    init = ranks["init"]["conv"]
    m = _nets()["build"](tnn, "conv")
    m.load_parameters_dict(init[0])
    m.load_states_dict(init[1])
    return m


def test_world_of_one_equals_local_optimizer(ranks, engine):
    inp = ranks["inp"]
    data = (inp["x_conv"], inp["y_conv"])
    res = []
    for cls in (toptim.LocalOptimizer, toptim.DistriOptimizer):
        m = _conv_model(ranks)
        opt = cls(m, data, tnn.ClassNLLCriterion(), BATCH,
                  toptim.Trigger.max_iteration(STEPS), device="cpu")
        opt.set_optim_method(toptim.SGD(0.1, momentum=0.9))
        opt.optimize()
        res.append((opt.state["loss"], m.parameters_dict(),
                    m.states_dict()))
    assert engine.is_initialized() and engine.world_size() == 1
    assert engine.config().engine_type == "cpu"
    assert res[0][0] == res[1][0]
    for i in (1, 2):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(
                a.detach().numpy(), b.detach().numpy()), res[0][i],
            res[1][i])


def test_keras_fit_defaults_match_jax(engine):
    """``fit`` with its defaults trains through ``DistriOptimizer`` (JAX:
    over the Engine's 8-device mesh; the port: NCCL / here gloo at world
    1) to the same weights."""
    rs = np.random.RandomState(0)
    x = rs.rand(64, 10).astype(np.float32)
    y = (x @ rs.randn(10, 3)).argmax(1).astype(np.float32)

    def mlp(K):
        m = K.Sequential()
        m.add(K.Dense(8, activation="relu", input_shape=(10,)))
        m.add(K.Dense(3, activation="softmax"))
        m.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
        return m

    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    try:
        jset_seed(3)
        jm = mlp(JK)
    finally:
        RNG._key, FORWARD_RNG._key = keys
    tm = mlp(TK)
    tm.set_weights(jax.tree_util.tree_map(np.asarray, jm.get_weights()))
    assert type(tm.fit_optimizer(x, y, batch_size=16, device="cpu")) is \
        toptim.DistriOptimizer
    jm.fit(x, y, batch_size=16, nb_epoch=2)
    tm.fit(x, y, batch_size=16, nb_epoch=2, device="cpu")
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5),
        tm.get_weights(), jax.tree_util.tree_map(np.asarray,
                                                 jm.get_weights()))


def test_checkpoint_from_two_ranks_is_refused_alone(ranks, engine):
    ck = os.path.join(ranks["work"], "ckpt")
    tag = tckpt.latest(ck, prefix="optim.", paired_prefix="model.")
    assert tag == "1.3", tag
    blob, _ = tckpt.load_checkpoint(os.path.join(ck, f"optim.{tag}"))
    assert blob["world"] == {"processes": 2, "devices": 2,
                             "mesh_shape": [2], "mesh_axes": ["data"]}
    inp = ranks["inp"]
    for cls in (toptim.LocalOptimizer, toptim.DistriOptimizer):
        m = _nets()["build"](tnn, "mlp")
        opt = cls(m, (inp["x_mlp"], inp["y_mlp"]), tnn.ClassNLLCriterion(),
                  BATCH, device="cpu")
        with pytest.raises(ValueError, match="different world"):
            opt.resume_from_checkpoint(ck, tag)
        assert opt.state["iteration_done"] == 0


def _init_failures():
    m = re.search(r"^bigdl_engine_init_failures_total (\S+)$",
                  tobs.render(), re.M)
    return float(m.group(1)) if m else 0.0


def test_engine_failure_contract(engine, monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    base = _init_failures()
    with pytest.raises(RuntimeError, match="explicitly configured"):
        engine.init(engine_type="cpu", coordinator_address="127.0.0.1:1",
                    num_processes=2, process_id=1, timeout_s=0.5)
    assert not dist.is_initialized() and not engine.is_initialized()
    assert _init_failures() == base + 1
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    mesh = engine.init(engine_type="cpu", timeout_s=0.5)
    assert engine.world_size() == 1 and mesh.shape == (1,)
    assert _init_failures() == base + 2
    engine.reset()
    assert not dist.is_initialized()
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toptim.DistriOptimizer(tnn.Linear(2, 2), (np.zeros((4, 2)),
                                                  np.zeros(4)),
                               tnn.MSECriterion(), 4)
    with pytest.raises(ValueError, match="does not cover"):
        engine.init(engine_type="cpu", mesh_shape=(2,))
    assert not dist.is_initialized()
    mesh = engine.init(engine_type="cpu", mesh_axes=("data", "model"))
    assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (1, 1)
    with pytest.raises(ValueError, match="unknown gradient compression"):
        toptim.DistriOptimizer(tnn.Linear(2, 2), (np.zeros((4, 2)),
                                                  np.zeros(4)),
                               tnn.MSECriterion(), 4, device="cpu"
                               ).set_gradient_compression("fp8")


def test_resolving_the_gpu_sets_the_split_limit(monkeypatch):
    """Resolving to the GPU before CUDA starts adds the allocator's split
    limit unless the caller named one (either variable); once CUDA has
    started, or on the CPU, nothing changes."""
    from bigdl_tpu_torch import device
    for v in ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    device.resolve_device("cpu")
    assert "PYTORCH_CUDA_ALLOC_CONF" not in os.environ
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:False")
    assert device.resolve_device(None).type == "cuda"
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == \
        "expandable_segments:False," + device.SPLIT_LIMIT
    assert not device.set_split_limit()
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF")
    monkeypatch.setenv("PYTORCH_ALLOC_CONF", "max_split_size_mb:64")
    device.resolve_device("cuda:0")
    assert "PYTORCH_CUDA_ALLOC_CONF" not in os.environ
    monkeypatch.delenv("PYTORCH_ALLOC_CONF")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not device.set_split_limit()
    assert "PYTORCH_CUDA_ALLOC_CONF" not in os.environ

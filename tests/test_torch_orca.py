"""The port's Orca runtime and Estimators (``bigdl_tpu_torch.orca``) held
to the JAX package on the CPU.

- ``XShards``: every operation gives the JAX class's partitions.
- ``Estimator.from_bigdl``: a Keras regression-classifier and
  ``BertConfig.tiny`` trained from the same weights on the same merged
  shards — the port through ``DistriOptimizer`` at world 1 (gloo), the
  JAX package through its ``DistriOptimizer`` on the CPU mesh; weights
  within 1e-5 (Keras MLP, 25 epochs of Adam) and 2e-5 (BERT tiny, 6
  Adam steps): f32 sums in another order. The attention key biases are
  the exception: their exact gradient is zero (a bias on every key adds
  one constant to a query's scores), so both packages step them by
  Adam's normalised rounding noise, up to lr a step; they are held to
  6 x lr. The evaluation results and predictions within the same
  tolerance.
- ``Estimator.from_torch``: the port's loop and the JAX package's host
  loop on one seeded torch model and the same shards: weights and
  per-shard losses bit for bit.
- ``Estimator.from_keras(backend="tf2")`` where ``tensorflow`` is
  importable: the same losses and predictions as the JAX estimator.
- ``RayContext``: remote calls, map and remote errors, and the standard
  library's pickle refusing a closure in the parent with a clear error.
"""

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.keras as JK
from bigdl_tpu import orca as jorca
from bigdl_tpu.models.bert import BertConfig as JBertConfig
from bigdl_tpu.models.bert import build_classifier as jbuild_classifier
from bigdl_tpu.nn.module import set_seed as jset_seed
from bigdl_tpu.optim.optim_method import Adam as JAdam
from bigdl_tpu.orca.learn import Estimator as JEstimator

import bigdl_tpu_torch.keras as TK
from bigdl_tpu_torch import orca as torca
from bigdl_tpu_torch.models.bert import BertConfig, build_classifier
from bigdl_tpu_torch.optim.optim_method import Adam
from bigdl_tpu_torch.orca.learn import Estimator
from bigdl_tpu_torch.orca.ray_pool import RemoteError, TaskNotPicklable


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _items(tree, prefix=""):
    """``(dotted path, leaf)`` in sorted-key order (``tree_leaves``')."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


@pytest.fixture(scope="module", autouse=True)
def _contexts():
    jctx = jorca.init_orca_context(cluster_mode="local-cpu")
    tctx = torca.init_orca_context(cluster_mode="local-cpu",
                                   some_spark_arg=1)
    assert tctx.num_devices == 1 and tctx.mesh.mesh_dim_names == ("data",)
    yield
    torca.stop_orca_context()
    jorca.stop_orca_context()


# ---------------------------------------------------------------------------
# XShards
# ---------------------------------------------------------------------------

_RS = np.random.RandomState(0)
_DICT = {"x": _RS.rand(10, 2).astype(np.float32), "y": np.arange(10)}
_TUPLE = (_RS.rand(9, 3), _RS.rand(9))


def _shard_ops(pkg):
    XS = pkg.XShards
    d = XS.partition(_DICT, num_shards=3)
    t = XS.partition(_TUPLE, num_shards=2)
    a = XS.partition(np.arange(12), num_shards=4)
    doubled = a.transform_shard(lambda v, k: v * k, 2)
    return [d.collect(), d.num_partitions(), len(d), d.merged(),
            d.repartition(2).collect(), t.collect(), t.merged(),
            a.collect(), doubled.merged(), doubled.repartition(3).collect(),
            d.transform_shard(lambda p: {"x": p["x"] + 1,
                                         "y": p["y"]}).merged()]


def _flat(v):
    if isinstance(v, dict):
        return [(k, _flat(x)) for k, x in sorted(v.items())]
    if isinstance(v, (list, tuple)):
        return [_flat(x) for x in v]
    return np.asarray(v).tolist()


def test_xshards_ops_match_jax():
    assert _flat(_shard_ops(torca)) == _flat(_shard_ops(jorca))


def test_read_csv_matches_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    from bigdl_tpu.orca.data import read_csv as jread_csv
    from bigdl_tpu_torch.orca.data import read_csv
    df = pd.DataFrame({"a": range(10), "b": np.arange(10) * 0.5})
    p = tmp_path / "data.csv"
    df.to_csv(p, index=False)
    got = [s.to_dict("list") for s in read_csv(str(p), 3).collect()]
    want = [s.to_dict("list") for s in jread_csv(str(p), 3).collect()]
    assert got == want and len(got) == 3


# ---------------------------------------------------------------------------
# Estimator.from_bigdl
# ---------------------------------------------------------------------------

def _keras_mlp(K):
    m = K.Sequential()
    m.add(K.Dense(16, activation="relu", input_shape=(6,)))
    m.add(K.Dense(2, activation="softmax"))
    return m


def _regression_case():
    rs = np.random.RandomState(0)
    x = rs.rand(128, 6).astype(np.float32)
    w = rs.randn(6, 2).astype(np.float32)
    y = (x @ w).argmax(1).astype(np.int32)
    jm, tm = _keras_mlp(JK), _keras_mlp(TK)
    tm.module.load_parameters_dict(_np(jm.module.parameters_dict()))
    data = {"x": x, "y": y}
    kw = dict(loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    return (jm, tm, JAdam(learning_rate=0.02), Adam(learning_rate=0.02),
            kw, data, dict(epochs=25, batch_size=32), 1e-5)


def _bert_case():
    jset_seed(0)
    jm = jbuild_classifier(JBertConfig.tiny(), 2)
    tm = build_classifier(BertConfig.tiny(), 2, device="cpu")
    tm.load_parameters_dict(_np(jm.parameters_dict()))
    rs = np.random.RandomState(2)
    x = rs.randint(1, 64, (96, 16)).astype(np.int32)
    y = (x[:, 0] > 32).astype(np.int32) + 1            # 1-based labels
    import bigdl_tpu.nn as jnn
    import bigdl_tpu_torch.nn as tnn
    return (jm, tm, JAdam(learning_rate=2e-3), Adam(learning_rate=2e-3),
            dict(metrics=["accuracy"]), {"x": x, "y": y},
            dict(epochs=2, batch_size=32), 2e-5,
            jnn.ClassNLLCriterion(), tnn.ClassNLLCriterion(),
            {"attention.k.bias": 6 * 2e-3})


@pytest.mark.parametrize("case", [_regression_case, _bert_case],
                         ids=["keras_regression", "bert_tiny"])
def test_bigdl_estimator_matches_jax(case):
    c = case()
    jm, tm, jopt, topt, kw, data, fit, tol = c[:8]
    jkw, tkw = dict(kw), dict(kw)
    noise = {}
    if len(c) > 8:
        jkw["loss"], tkw["loss"] = c[8], c[9]
        noise = c[10]
    jest = JEstimator.from_bigdl(model=jm, optimizer=jopt, **jkw)
    test = Estimator.from_bigdl(model=tm, optimizer=topt, device="cpu",
                                distributed=True, **tkw)
    jshards = jorca.XShards.partition(data, num_shards=4)
    tshards = torca.XShards.partition(data, num_shards=4)
    jest.fit(jshards, **fit)
    test.fit(tshards, **fit)
    assert type(test.optimizer).__name__ == "DistriOptimizer"
    want = [np.asarray(v) for v in
            jax.tree_util.tree_leaves(jest.get_model().parameters_dict())]
    got = list(_items(test.get_model().parameters_dict()))
    assert len(got) == len(want)
    for (path, a), b in zip(got, want):
        atol = next((t for k, t in noise.items() if path.endswith(k)), tol)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=atol, err_msg=path)
    np.testing.assert_allclose(test.predict(tshards), jest.predict(jshards),
                               rtol=0, atol=tol)
    (tr,), (jr,) = test.evaluate(tshards), jest.evaluate(jshards)
    assert abs(tr.result - jr.result) <= 1.0 / len(data["y"])


# ---------------------------------------------------------------------------
# Estimator.from_torch
# ---------------------------------------------------------------------------

def _torch_creators():
    def model_creator(config):
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.ReLU(),
                                   torch.nn.Linear(16, 1))

    def optim_creator(model, config):
        return torch.optim.Adam(model.parameters(), lr=config["lr"])

    return dict(model_creator=model_creator,
                optimizer_creator=optim_creator,
                loss_creator=lambda cfg: torch.nn.MSELoss(),
                config={"lr": 5e-3}, backend="spark")


def test_torch_estimator_bit_equal_to_jax():
    rs = np.random.RandomState(1)
    x = rs.rand(200, 4).astype(np.float32)
    y = (x.sum(1, keepdims=True) * 1.5).astype(np.float32)
    jest = JEstimator.from_torch(**_torch_creators())
    test = Estimator.from_torch(device="cpu", **_torch_creators())
    jstats = jest.fit(jorca.XShards.partition({"x": x, "y": y}, 4),
                      epochs=5, batch_size=32)
    tstats = test.fit(torca.XShards.partition({"x": x, "y": y}, 4),
                      epochs=5, batch_size=32)
    assert tstats == jstats and len(tstats) == 20
    for a, b in zip(test.get_model().state_dict().values(),
                    jest.get_model().state_dict().values()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(test.predict(x), jest.predict(x))
    assert test.evaluate((x, y)) == jest.evaluate((x, y))


def test_tf2_estimator_matches_jax():
    tf = pytest.importorskip("tensorflow")

    def model_creator(config):
        tf.keras.utils.set_random_seed(0)
        m = tf.keras.Sequential([
            tf.keras.layers.Dense(32, activation="relu", input_shape=(10,)),
            tf.keras.layers.Dense(3, activation="softmax")])
        m.compile(optimizer=tf.keras.optimizers.Adam(config["lr"]),
                  loss=tf.keras.losses.SparseCategoricalCrossentropy())
        return m

    rs = np.random.RandomState(0)
    x = rs.randn(120, 10).astype(np.float32)
    y = (x @ rs.randn(10, 3)).argmax(1).astype(np.int64)
    out = []
    for est_cls, pkg in ((JEstimator, jorca), (Estimator, torca)):
        est = est_cls.from_keras(model_creator=model_creator,
                                 config={"lr": 5e-3}, backend="tf2")
        stats = est.fit(pkg.XShards.partition({"x": x, "y": y}, 2),
                        epochs=3, batch_size=32)
        out.append((stats, est.predict(x), est.evaluate({"x": x, "y": y})))
    (js, jp, je), (ts, tp, te) = out
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    assert te == je and ts[-1] < ts[0]


# ---------------------------------------------------------------------------
# RayContext
# ---------------------------------------------------------------------------

def test_ray_pool_runs_tasks_and_refuses_closures():
    # builtins as tasks: a worker unpickles them without importing this
    # module (and with it JAX and both packages)
    with torca.RayContext(num_workers=2) as ctx:
        assert ctx.get(ctx.remote(pow)(7, 2), timeout=60) == 49
        assert ctx.map(abs, [-1, 2, -3], timeout=60) == [1, 2, 3]
        with pytest.raises(RemoteError, match="ValueError: invalid literal"):
            ctx.get(ctx.remote(int)("nope"), timeout=60)
        k = 10
        with pytest.raises(TaskNotPicklable, match="closure or a lambda"):
            ctx.remote(lambda v: v + k)(5)

        def nested(v):
            return v + k
        with pytest.raises(TaskNotPicklable, match="module level"):
            ctx.map(nested, [1])
        # the pool is still whole after the refusals
        assert ctx.map(abs, [-4], timeout=60) == [4]

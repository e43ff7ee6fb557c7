"""The port's ``nnframes`` (``bigdl_tpu_torch.nnframes``) held to the JAX
package's on the CPU, on one pandas frame from a seed.

``NNClassifier`` and ``NNEstimator`` start from the JAX model's weights
(carried with ``load_parameters_dict``) and train through each package's
``Optimizer`` on the same batches (``LocalDataSet``'s seeded shuffle):
each weight within 1e-4 of the largest after training (f32 sums in
another order), the transformed frame's predictions within 1e-4, and a
classifier's 1-based float labels equal. ``NNModel.save`` / ``load``
round-trips; ``NNImageReader`` reads the same images and origins.
"""

import io

import numpy as np
import pandas as pd
import pytest

import jax

import bigdl_tpu.nn as jnn
import bigdl_tpu.nnframes as jframes
import bigdl_tpu.optim.optim_method as jmethod
from bigdl_tpu.nn.module import set_seed as jset_seed

import bigdl_tpu_torch.nn as tnn
import bigdl_tpu_torch.nnframes as tframes
import bigdl_tpu_torch.optim.optim_method as tmethod


def _mlp(nn):
    return (nn.Sequential().add(nn.Linear(8, 16)).add(nn.ReLU())
            .add(nn.Linear(16, 3)).add(nn.LogSoftMax()))


def _conv(nn):
    return (nn.Sequential().add(nn.SpatialConvolution(1, 3, 3, 3))
            .add(nn.ReLU()).add(nn.Reshape([48])).add(nn.Linear(48, 3))
            .add(nn.LogSoftMax()))


def _frame(kind, n=96, seed=0):
    rs = np.random.RandomState(seed)
    d = {"mlp": 8, "conv": 36, "regression": 4}[kind]
    x = rs.rand(n, d).astype(np.float32)
    if kind == "regression":
        return pd.DataFrame({"feat": [list(r) for r in x],
                             "target": [[v] for v in x.sum(1) * 2]})
    w = rs.randn(d, 3).astype(np.float32)
    return pd.DataFrame({"features": [list(r) for r in x],
                         "label": (x @ w).argmax(1) + 1.0})


# name: (model, criterion, estimator kwargs, setters)
CASES = {
    "classifier_adam": (_mlp, "ClassNLLCriterion", {}, dict(
        set_batch_size=32, set_max_epoch=4,
        set_optim_method=("Adam", dict(learning_rate=0.01)))),
    "classifier_learning_rate_only": (_mlp, "ClassNLLCriterion", {}, dict(
        set_batch_size=16, set_max_epoch=3, set_learning_rate=0.1)),
    "classifier_feature_size": (_conv, "ClassNLLCriterion",
                                dict(feature_size=[1, 6, 6]), dict(
        set_batch_size=24, set_max_epoch=3,
        set_optim_method=("SGD", dict(learning_rate=0.1, momentum=0.9)))),
    "estimator_regression": (lambda nn: nn.Sequential().add(nn.Linear(4, 1)),
                             "MSECriterion", dict(feature_size=[4]), dict(
        set_features_col="feat", set_label_col="target",
        set_prediction_col="out", set_batch_size=16, set_max_epoch=5,
        set_optim_method=("SGD", dict(learning_rate=0.3)),
        set_learning_rate=0.2)),
}


def _estimator(pkg, nn, method, name, model, dev):
    build, crit, kw, setters = CASES[name]
    cls = pkg.NNEstimator if name.startswith("estimator") \
        else pkg.NNClassifier
    est = cls(model, getattr(nn, crit)(), **kw, **dev)
    for setter, arg in setters.items():
        if isinstance(arg, tuple):
            arg = getattr(method, arg[0])(**arg[1])
        getattr(est, setter)(arg)
    return est


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), np.asarray(tree)


@pytest.mark.parametrize("name", list(CASES))
def test_fit_transform_equal_jax(name, tmp_path):
    build = CASES[name][0]
    df = _frame("regression" if name.startswith("estimator") else
                "conv" if "feature_size" in name else "mlp")
    jset_seed(0)
    jmodel = build(jnn)
    tmodel = build(tnn)
    tmodel.load_parameters_dict(jax.tree_util.tree_map(
        np.asarray, jmodel.parameters_dict()))
    jfit = _estimator(jframes, jnn, jmethod, name, jmodel, {}).fit(df)
    tfit = _estimator(tframes, tnn, tmethod, name, tmodel,
                      {"device": "cpu"}).fit(df)
    assert type(tfit).__name__ == type(jfit).__name__
    jw = dict(_items(jax.tree_util.tree_map(np.asarray,
                                            jmodel.parameters_dict())))
    tw = dict(_items(tmodel.get_weights()))
    top = max(float(np.abs(v).max()) for v in jw.values())
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], atol=1e-4 * top, rtol=0)
    jout, tout = jfit.transform(df), tfit.transform(df)
    col = tfit.prediction_col
    assert list(tout.columns) == list(jout.columns)
    if name.startswith("classifier"):
        assert tout[col].dtype == np.float64
        np.testing.assert_array_equal(tout[col].to_numpy(),
                                      jout[col].to_numpy())
    else:
        np.testing.assert_allclose(np.stack(tout[col].to_numpy()),
                                   np.stack(jout[col].to_numpy()),
                                   atol=1e-4)
    tfit.save(str(tmp_path / "m"))
    back = tframes.NNModel.load(str(tmp_path / "m"), device="cpu")
    back.features_col, back.feature_size = tfit.features_col, \
        tfit.feature_size
    np.testing.assert_array_equal(
        np.stack(back.transform(df)["prediction"].to_numpy()),
        np.stack(tframes.NNModel.transform(tfit, df)[col].to_numpy()))


def test_image_reader_equal_jax(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(0)
    for i, (h, w) in enumerate([(16, 16), (12, 20)]):
        buf = io.BytesIO()
        Image.fromarray(rs.randint(0, 255, (h, w, 3), dtype=np.uint8)
                        ).save(buf, format="PNG")
        (tmp_path / f"{i}.png").write_bytes(buf.getvalue())
    pattern = str(tmp_path / "*.png")
    j = jframes.NNImageReader.read_images(pattern)
    t = tframes.NNImageReader.read_images(pattern)
    assert list(t.columns) == list(j.columns)
    assert list(t["origin"]) == list(j["origin"])
    for a, b in zip(t["image"], j["image"]):
        np.testing.assert_array_equal(a, b)

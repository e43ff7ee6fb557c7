"""The port's nano (``bigdl_tpu_torch.nano``: ``InferenceOptimizer``'s
``optimize`` / ``save`` / ``load`` / ``summary`` / ``get_best_model`` and
``Trainer``) held to the JAX package on the CPU.

- ``optimize`` on the same weights (an MLP whose K takes the block
  formats, one whose K does not, and ``BertConfig.tiny``): the report's
  pipelines and statuses equal the JAX report's; each successful
  pipeline's output within the pipeline's tolerance of the JAX one's
  (f32: 1e-5; bf16 and the int8 / int4 formats: 3e-2 of the output's
  scale, their rounding against JAX's); ``summary``'s text equal with the
  latencies masked; ``get_best_model`` names a successful pipeline and
  returns its model.
- ``save`` then ``load``: each of the five pipelines on BERT tiny reloads
  with outputs bit for bit equal, and ``_aot`` stays ``None`` (the port
  writes no compiled artifact).
- ``Trainer.fit`` against the JAX ``Trainer`` from the same weights: f32
  within 1e-5; ``precision="bf16"`` within 2^-6 of the weights' scale
  (the port computes in bf16, the JAX package promotes to f32); the
  two-process ``Trainer`` (spawned pool workers, averaged each round)
  against the JAX two-process ``Trainer`` on the same shards within
  1e-5, its losses falling.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import bigdl_tpu.nn as jnn
from bigdl_tpu.models.bert import BertConfig as JBertConfig
from bigdl_tpu.models.bert import build_classifier as jbuild_classifier
from bigdl_tpu.nano import InferenceOptimizer as JIO
from bigdl_tpu.nano import Trainer as JTrainer
from bigdl_tpu.nn.module import set_seed as jset_seed
from bigdl_tpu.optim.optim_method import SGD as JSGD

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.models.bert import BertConfig, build_classifier
from bigdl_tpu_torch.nano import InferenceOptimizer, Trainer
from bigdl_tpu_torch.optim.optim_method import SGD
from bigdl_tpu_torch.utils.tree import tree_leaves

_TOL = {"original(jit)": 1e-5, "bf16": 3e-2, "int8": 3e-2,
        "int8-conv": 3e-2, "int4": 3e-2}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mlp(nn, in_dim):
    return (nn.Sequential().add(nn.Linear(in_dim, 16)).add(nn.ReLU())
            .add(nn.Linear(16, 3)).add(nn.SoftMax()))


def _pair(which):
    """``(jax model, port model carrying its weights, input)``."""
    rs = np.random.RandomState(0)
    jset_seed(0)
    if which == "bert":
        jm = jbuild_classifier(JBertConfig.tiny(), 2)
        tm = build_classifier(BertConfig.tiny(), 2, device="cpu")
        x = rs.randint(1, 64, (4, 16)).astype(np.int32)
    else:
        k = int(which[3:])
        jm, tm = _mlp(jnn, k), _mlp(tnn, k)
        x = rs.rand(4, k).astype(np.float32)
    tm.load_parameters_dict(_np(jm.parameters_dict()))
    return jm, tm, x


def _status(entry):
    return "failed" if entry["status"].startswith("failed") \
        else entry["status"]


def _masked(text):
    return [line[:16] + line[29:] for line in text.splitlines()]


@pytest.mark.parametrize("which", ["mlp32", "mlp6", "bert"])
def test_optimize_report_matches_jax(which):
    jm, tm, x = _pair(which)
    jrep = JIO.optimize(jm, x, latency_sample_num=2)
    trep = InferenceOptimizer.optimize(tm, x, latency_sample_num=2,
                                       device="cpu")
    assert list(trep) == list(jrep)
    assert {k: _status(e) for k, e in trep.items()} == \
        {k: _status(e) for k, e in jrep.items()}
    assert trep["original(jit)"]["status"] == "successful"
    for name, e in trep.items():
        if e["status"] != "successful":
            continue
        assert set(e) == set(jrep[name])
        assert e["model"].trial_launches == {}      # no kernel on the CPU
        want = np.asarray(jrep[name]["model"](x))
        got = e["model"](x)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_TOL[name] * scale, err_msg=name)
    assert _masked(InferenceOptimizer.summary(trep)) == \
        _masked(JIO.summary(jrep))
    best, name = InferenceOptimizer.get_best_model(trep)
    assert trep[name]["status"] == "successful"
    assert best is trep[name]["model"]
    assert best(x).shape == np.asarray(jrep["original(jit)"]["model"](
        x)).shape


@pytest.mark.parametrize("pipeline", list(_TOL))
def test_saved_pipeline_reloads_bit_equal(pipeline, tmp_path):
    _, tm, x = _pair("bert")
    build = {"original(jit)": lambda: InferenceOptimizer.trace(
                 tm, device="cpu"),
             "int8-conv": lambda: InferenceOptimizer._quantize_convs(
                 tm, device="cpu")}.get(pipeline, lambda: (
                 InferenceOptimizer.quantize(
                     tm, {"int4": "sym_int4"}.get(pipeline, pipeline),
                     device="cpu")))
    pipe = build()
    want = pipe(x)
    path = str(tmp_path / "nano_art")
    InferenceOptimizer.save(pipe, path)
    with open(os.path.join(path, "nano_meta.json")) as f:
        meta = json.load(f)
    assert meta["example_shape"] == [4, 16]
    assert meta["dtype"] == ("bfloat16" if pipeline == "bf16" else None)
    loaded = InferenceOptimizer.load(path, device="cpu")
    assert loaded._aot is None
    np.testing.assert_array_equal(loaded(x), want)
    x2 = np.random.RandomState(1).randint(1, 64, (2, 8)).astype(np.int32)
    np.testing.assert_array_equal(loaded(x2), pipe(x2))


def _regression():
    rs = np.random.RandomState(0)
    x = rs.rand(128, 4).astype(np.float32)
    return x, x.sum(1, keepdims=True).astype(np.float32)


@pytest.mark.parametrize("precision, processes, epochs, tol", [
    ("32", 1, 30, 1e-5), ("bf16", 1, 10, 2.0 ** -6), ("32", 2, 4, 1e-5)],
    ids=["f32", "bf16", "two_processes"])
def test_trainer_matches_jax(precision, processes, epochs, tol):
    x, y = _regression()
    jset_seed(2)
    jm = jnn.Sequential().add(jnn.Linear(4, 1))
    tm = tnn.Sequential().add(tnn.Linear(4, 1))
    tm.load_parameters_dict(_np(jm.parameters_dict()))
    opt = dict(learning_rate=0.2, momentum=0.9 if processes > 1 else 0.0)
    jtr = JTrainer(max_epochs=epochs, precision=precision,
                   num_processes=processes)
    jtr.fit(jm, jnn.MSECriterion(), x, y, batch_size=16,
            optim_method=JSGD(**opt))
    ttr = Trainer(max_epochs=epochs, precision=precision,
                  num_processes=processes, device="cpu")
    ttr.fit(tm, tnn.MSECriterion(), x, y, batch_size=16,
            optim_method=SGD(**opt))
    want = [np.asarray(v, np.float32) for v in
            jax.tree_util.tree_leaves(jm.parameters_dict())]
    got = [p.detach().float().numpy()
           for p in tree_leaves(tm.parameters_dict())]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * max(1.0, np.abs(b).max()))
    assert len(ttr.last_losses) == len(jtr.last_losses)
    np.testing.assert_allclose(ttr.last_losses, jtr.last_losses, rtol=0,
                               atol=max(tol, 1e-5) * 10)
    if processes > 1:
        assert ttr.last_losses[-1] < ttr.last_losses[0]
    assert {p.dtype for p in tm.parameters()} == (
        {torch.bfloat16} if precision == "bf16" else {torch.float32})

"""The port's Keras API held to the JAX package's on the CPU: every
layer builds its module in both packages from one input shape, the JAX
weights are carried over, and the same seeded input gives the same
output (rtol 1e-4 / atol 1e-5) of the shape the layer computes (the
random layers in eval mode, and their shape in train mode);
``Sequential`` and a functional ``Model`` train through ``fit`` at
``distributed=False`` from the same weights and agree in their weights
(rtol 1e-4 / atol 1e-5), ``evaluate`` and ``predict``; ``fit``'s default
``distributed=True`` raises the "Queue 1 item 10" message."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.keras as JK
from bigdl_tpu.nn.module import set_seed as jset_seed

import bigdl_tpu_torch.keras as TK
import bigdl_tpu_torch.nn as tnn

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# (id, build(K namespace), input shape without the batch, input kind,
#  mode: "train" deterministic / "eval" for the random layers)
C2 = (3, 9, 8)
SEQ = (6, 4)
V3 = (2, 5, 6, 4)
LAYERS = [
    ("InputLayer", lambda K: K.InputLayer(), (5,), None, "train"),
    ("Dense", lambda K: K.Dense(4), (5,), None, "train"),
    ("Dense relu no bias", lambda K: K.Dense(4, "relu", bias=False), SEQ,
     None, "train"),
    ("Dropout", lambda K: K.Dropout(0.3), (5,), None, "eval"),
    ("Flatten", lambda K: K.Flatten(), C2, None, "train"),
    ("Reshape", lambda K: K.Reshape((4, -1)), (2, 6), None, "train"),
    ("Permute", lambda K: K.Permute((3, 1, 2)), C2, None, "train"),
    ("RepeatVector", lambda K: K.RepeatVector(3), (5,), None, "train"),
    ("Convolution2D", lambda K: K.Convolution2D(4, 3, 2), C2, None, "train"),
    ("Convolution2D same s2 tanh", lambda K: K.Convolution2D(
        4, 3, 5, "tanh", "same", (2, 2)), C2, None, "train"),
    ("Conv2D s(1,2) no bias", lambda K: K.Conv2D(
        2, 2, 3, subsample=(1, 2), bias=False), C2, None, "train"),
    ("Deconvolution2D", lambda K: K.Deconvolution2D(2, 3, 2, "relu",
                                                    (2, 1)), C2, None,
     "train"),
    ("SeparableConvolution2D", lambda K: K.SeparableConvolution2D(
        4, 3, 3, depth_multiplier=2, subsample=(2, 1)), C2, None, "train"),
    ("Convolution1D", lambda K: K.Convolution1D(5, 3, "sigmoid", 2), SEQ,
     None, "train"),
    ("MaxPooling2D", lambda K: K.MaxPooling2D(), C2, None, "train"),
    ("MaxPooling2D same s(2,1)", lambda K: K.MaxPooling2D(
        (3, 3), (2, 1), "same"), C2, None, "train"),
    ("AveragePooling2D", lambda K: K.AveragePooling2D((2, 3)), C2, None,
     "train"),
    ("AveragePooling2D same", lambda K: K.AveragePooling2D(
        (3, 3), (2, 2), "same"), C2, None, "train"),
    ("MaxPooling1D", lambda K: K.MaxPooling1D(2), SEQ, None, "train"),
    ("AveragePooling1D", lambda K: K.AveragePooling1D(3, 2), (7, 4), None,
     "train"),
    ("GlobalMaxPooling2D", lambda K: K.GlobalMaxPooling2D(), C2, None,
     "train"),
    ("GlobalAveragePooling2D", lambda K: K.GlobalAveragePooling2D(), C2,
     None, "train"),
    ("GlobalMaxPooling1D", lambda K: K.GlobalMaxPooling1D(), SEQ, None,
     "train"),
    ("GlobalAveragePooling1D", lambda K: K.GlobalAveragePooling1D(), SEQ,
     None, "train"),
    ("ZeroPadding2D", lambda K: K.ZeroPadding2D((1, 2)), C2, None, "train"),
    ("UpSampling2D", lambda K: K.UpSampling2D((2, 3)), C2, None, "train"),
    ("UpSampling1D", lambda K: K.UpSampling1D(3), SEQ, None, "train"),
    ("BatchNormalization 4-D", lambda K: K.BatchNormalization(), C2, None,
     "train"),
    ("BatchNormalization 2-D", lambda K: K.BatchNormalization(1e-5, 0.9),
     (5,), None, "train"),
    ("Embedding", lambda K: K.Embedding(11, 4, input_length=6), (6,),
     "ids", "train"),
    ("SimpleRNN", lambda K: K.SimpleRNN(5), SEQ, None, "train"),
    ("SimpleRNN relu seq back", lambda K: K.SimpleRNN(
        5, "relu", return_sequences=True, go_backwards=True), SEQ, None,
     "train"),
    ("LSTM", lambda K: K.LSTM(5), SEQ, None, "train"),
    ("LSTM seq", lambda K: K.LSTM(5, return_sequences=True), SEQ, None,
     "train"),
    ("GRU back", lambda K: K.GRU(5, go_backwards=True), SEQ, None, "train"),
    ("Bidirectional", lambda K: K.Bidirectional(K.LSTM(3)), SEQ, None,
     "train"),
    ("Bidirectional seq sum", lambda K: K.Bidirectional(
        K.GRU(3, return_sequences=True), "sum"), SEQ, None, "train"),
    ("TimeDistributed", lambda K: K.TimeDistributed(K.Dense(3, "tanh")),
     SEQ, None, "train"),
    ("LeakyReLU", lambda K: K.LeakyReLU(0.2), (5,), None, "train"),
    ("ELU", lambda K: K.ELU(0.5), (5,), None, "train"),
    ("PReLU", lambda K: K.PReLU(), (5,), None, "train"),
    ("ThresholdedReLU", lambda K: K.ThresholdedReLU(0.4), (5,), None,
     "train"),
    ("Convolution3D", lambda K: K.Convolution3D(3, 3, 2, 3), V3, None,
     "train"),
    ("Convolution3D same s2 relu", lambda K: K.Convolution3D(
        3, 3, 3, 2, (2, 2, 1), "same", "relu"), V3, None, "train"),
    ("MaxPooling3D", lambda K: K.MaxPooling3D(), V3, None, "train"),
    ("MaxPooling3D same even pads", lambda K: K.MaxPooling3D(
        (3, 2, 3), (2, 2, 1), "same"), V3, None, "train"),
    ("AveragePooling3D same even pads", lambda K: K.AveragePooling3D(
        (3, 1, 3), (2, 2, 1), "same"), V3, None, "train"),
    ("AveragePooling3D", lambda K: K.AveragePooling3D((2, 2, 1)), V3, None,
     "train"),
    ("UpSampling3D", lambda K: K.UpSampling3D((1, 2, 2)), V3, None,
     "train"),
    ("Cropping1D", lambda K: K.Cropping1D((1, 2)), SEQ, None, "train"),
    ("Cropping2D", lambda K: K.Cropping2D(((1, 2), (0, 3))), C2, None,
     "train"),
    ("Highway", lambda K: K.Highway(), (5,), None, "train"),
    ("Highway relu", lambda K: K.Highway("relu"), (5,), None, "train"),
    ("Highway linear", lambda K: K.Highway("linear"), SEQ, None, "train"),
    ("Masking", lambda K: K.Masking(), SEQ, "masked", "train"),
    ("GaussianNoise", lambda K: K.GaussianNoise(0.2), (5,), None, "eval"),
    ("GaussianDropout", lambda K: K.GaussianDropout(0.2), (5,), None,
     "eval"),
    ("SpatialDropout2D", lambda K: K.SpatialDropout2D(0.3), C2, None,
     "eval"),
    ("LocallyConnected1D", lambda K: K.LocallyConnected1D(3, 3, 2, "tanh"),
     (7, 4), None, "train"),
    ("SpatialDropout1D", lambda K: K.layers.SpatialDropout1D(0.3), SEQ,
     None, "eval"),
    ("SpatialDropout3D", lambda K: K.layers.SpatialDropout3D(0.3), V3,
     None, "eval"),
    ("Cropping3D", lambda K: K.layers.Cropping3D(((1, 0), (2, 1), (0, 1))),
     V3, None, "train"),
    ("ZeroPadding3D", lambda K: K.layers.ZeroPadding3D((1, 0, 2)), V3, None,
     "train"),
    ("GlobalMaxPooling3D", lambda K: K.layers.GlobalMaxPooling3D(), V3,
     None, "train"),
    ("GlobalAveragePooling3D", lambda K: K.layers.GlobalAveragePooling3D(),
     V3, None, "train"),
    ("ActivityRegularization", lambda K: K.layers.ActivityRegularization(
        0.1, 0.1), (5,), None, "train"),
    ("SReLU", lambda K: K.layers.SReLU(), SEQ, None, "train"),
    ("LocallyConnected2D", lambda K: K.layers.LocallyConnected2D(
        2, 3, 2, (2, 1)), C2, None, "train"),
] + [(f"Activation {a}", (lambda a: lambda K: K.Activation(a))(a), (5,),
      None, "train")
     for a in ("relu", "tanh", "sigmoid", "hard_sigmoid", "softmax",
               "log_softmax", "softplus", "softsign", "elu", "selu", "gelu",
               "swish", "silu", "mish", "exp", "linear", "relu6")]


def _x(shape, kind, rs, n=2):
    if kind == "ids":
        return rs.randint(0, 11, (n,) + shape).astype(np.float32)
    x = rs.randn(*((n,) + shape)).astype(np.float32)
    if kind == "masked":
        x[:, 2] = 0.0
    return x


def _pair_built(build, shape):
    jl, tl = build(JK), build(TK)
    jm, tm = jl.build(shape), tl.build(shape)
    tm.load_parameters_dict(_np(jm.parameters_dict()))
    tm.load_states_dict(_np(jm.states_dict()))
    return jl, jm, tl, tm


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_shape_and_forward(case):
    name, build, shape, kind, mode = case
    rs = np.random.RandomState(0)
    x = _x(shape, kind, rs)
    jl, jm, tl, tm = _pair_built(build, shape)
    assert tl.output_shape == jl.output_shape, name
    jm.training() if mode == "train" else jm.evaluate()
    tm.train(mode == "train")
    want = np.asarray(jm.forward(x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2,) + tl.output_shape, (name, got.shape,
                                                tl.output_shape)
    np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    if mode == "eval":                 # the train-mode shape of a draw
        assert tm.train()(torch.from_numpy(x)).shape == got.shape


@pytest.mark.parametrize("mode", ["concat", "concat axis 2", "sum", "mul",
                                  "max", "ave", "dot"])
def test_merge(mode):
    rs = np.random.RandomState(1)
    shapes = [(3, 4), (5, 4)] if mode == "concat" else \
        [(3, 4), (3, 2)] if mode == "concat axis 2" else \
        [(4,)] * 2 if mode == "dot" else [(3, 4)] * 2
    axis = 2 if mode == "concat axis 2" else 1
    xs = [rs.randn(2, *s).astype(np.float32) for s in shapes]
    outs = []
    for K, run in ((JK, lambda m: np.asarray(m.forward(xs))),
                   (TK, lambda m: m([torch.from_numpy(v) for v in xs])
                    .numpy())):
        lay = K.Merge(mode.split()[0], concat_axis=axis)
        outs.append((lay, run(lay.build_multi(shapes))))
    (jl, jy), (tl, ty) = outs
    assert tl.output_shape == jl.output_shape
    assert ty.shape == (2,) + tl.output_shape
    # "dot": the JAX module gives (B,) where its shape states (1,); the
    # port gives the stated shape
    np.testing.assert_allclose(ty, jy.reshape(ty.shape), **TOL)


@pytest.mark.parametrize("name", ["ZeroPadding1D", "MaxPooling3D",
                                  "AveragePooling3D"])
def test_layers_where_the_jax_layer_is_at_fault(name):
    """Where the JAX layer is at fault the port gives what its output
    shape states. ``ZeroPadding1D``: the JAX layer raises (it passes
    ``nn.Padding`` an argument it does not take); the port pads T on both
    sides, as ``np.pad``. The 3-D pools at ``border_mode="same"`` with an
    odd total pad: the JAX module pads ceil(total / 2) on both sides and
    gives one more output than its shape says; the port pads as XLA's
    SAME does (``lax.reduce_window(..., "SAME")``)."""
    rs = np.random.RandomState(2)
    if name == "ZeroPadding1D":
        x = rs.randn(2, *SEQ).astype(np.float32)
        with pytest.raises(TypeError, match="n_index_end"):
            JK.ZeroPadding1D(2).build(SEQ)
        lay = TK.ZeroPadding1D(2)
        want = np.pad(x, ((0, 0), (2, 2), (0, 0)))
    else:
        x = rs.randn(2, *V3).astype(np.float32)
        k, st = (3, 2, 2), (2, 2, 1)          # W: 4 → total pad 1
        jl = getattr(JK, name)(k, st, "same")
        assert jl.build(V3).forward(x).shape[1:] != jl.output_shape
        lay = getattr(TK, name)(k, st, "same")
        red = (jax.lax.max, -np.inf) if name == "MaxPooling3D" \
            else (jax.lax.add, 0.0)
        want = np.asarray(jax.lax.reduce_window(
            jnp.asarray(x), red[1], red[0], (1, 1) + k, (1, 1) + st,
            "SAME"))
        if name == "AveragePooling3D":
            want = want / np.prod(k)
    got = lay.build(x.shape[1:])(torch.from_numpy(x)).numpy()
    assert got.shape == (2,) + lay.output_shape
    np.testing.assert_allclose(got, want, **TOL)


def _mlp(K):
    m = K.Sequential()
    m.add(K.Dense(8, activation="relu", input_shape=(10,)))
    m.add(K.Dense(3, activation="softmax"))
    m.compile("adam", "sparse_categorical_crossentropy", ["accuracy"])
    return m


def _functional(K):
    a = K.Input(shape=(3, 8, 8))
    c1 = K.Convolution2D(4, 3, 3, activation="relu", border_mode="same",
                         subsample=(2, 2))(a)
    c2 = K.Convolution2D(2, 1, 1, subsample=(2, 2))(a)
    p = K.MaxPooling2D((2, 2))(K.merge([c1, c2], mode="concat"))
    h = K.Dense(3)(K.Flatten()(p))
    m = K.Model(input=a, output=K.Activation("log_softmax")(h))
    m.compile("sgd", "class_nll")
    return m


@pytest.mark.parametrize("which", ["Sequential", "Model"])
def test_fit_evaluate_predict_match_jax(which):
    rs = np.random.RandomState(0)
    if which == "Sequential":
        x = rs.rand(64, 10).astype(np.float32)
        y = (x @ rs.randn(10, 3)).argmax(1).astype(np.float32)
        build = _mlp
    else:
        x = rs.rand(32, 3, 8, 8).astype(np.float32)
        y = (rs.randint(0, 3, 32) + 1).astype(np.float32)
        build = _functional
    jset_seed(3)
    jm, tm = build(JK), build(TK)
    tm.set_weights(_np(jm.get_weights()))
    jm.fit(x, y, batch_size=16, nb_epoch=2, distributed=False)
    tm.fit(x, y, batch_size=16, nb_epoch=2, distributed=False, device="cpu")
    got = tm.module.carry_keys(_np(jm.get_weights())) if which == "Model" \
        else _np(jm.get_weights())
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, **TOL),
        tm.get_weights(), got)
    for a, b in zip(tm.evaluate(x, y, device="cpu"), jm.evaluate(x, y)):
        np.testing.assert_allclose(a.result, b.result, rtol=1e-5)
    np.testing.assert_allclose(tm.predict(x[:7], device="cpu"),
                               np.asarray(jm.predict(x[:7])), **TOL)
    np.testing.assert_array_equal(
        tm.predict_classes(x[:7], device="cpu"),
        np.asarray(jm.predict_classes(x[:7])))


def test_fit_defaults_to_distributed_and_raises_item_10(tmp_path,
                                                        monkeypatch):
    """``fit``'s default ``distributed=True`` builds the JAX package's
    ``DistriOptimizer``; the port raises until ROADMAP Queue 1 item 10,
    and does not fall back to local training."""
    m = _mlp(TK)
    x = np.random.RandomState(0).rand(8, 10).astype(np.float32)
    y = np.zeros(8, np.float32)
    w0 = m.get_weights()
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        m.fit(x, y, batch_size=4, nb_epoch=1, device="cpu")
    jax.tree_util.tree_map(np.testing.assert_array_equal, m.get_weights(),
                           w0)
    with pytest.raises(RuntimeError, match="compile"):
        TK.Sequential().fit(x, y, distributed=False, device="cpu")
    m.save_model(str(tmp_path / "m"))
    back = tnn.Module.load_module(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(
        back.eval()(torch.from_numpy(x)).detach().numpy(),
        m.predict(x, device="cpu"))
    assert "Linear" in m.summary()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: m.fit(x, y, distributed=False),
                 lambda: m.evaluate(x, y), lambda: m.predict(x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_keras_namespace_matches_the_jax_one():
    assert sorted(TK.__all__) == sorted(JK.__all__)
    for n in JK.__all__:
        assert hasattr(TK, n), n
    with pytest.raises(ValueError, match="first layer needs"):
        TK.Sequential().add(TK.Dense(4))
    with pytest.raises(ValueError, match="unknown loss"):
        TK.Sequential().compile("sgd", "nope")

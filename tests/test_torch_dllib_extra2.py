"""The port's extra2 layers and its int8 ``nn.quantized.SpatialConvolution``
held to the JAX package on the CPU.

Each extra2 case builds the layer in both packages (random parameters
carried from the JAX module), feeds the same seeded numpy input and a
seeded output gradient, and compares the output and the vjp (the input's
and the parameters' gradients) at rtol 1e-4 / atol 1e-5 (gradients
1e-4). The quantized cases compare the ``q`` / ``scale`` states bit for
bit and the forward at rtol 1e-5 / atol 1e-5: ``quantize_model`` of
LeNet-5 swaps both convolutions and both linears for their int8 twins,
in both packages, and nano's ``_quantize_convs`` gives the same
output."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import quantized as jq
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.utils.table import Table as JTable

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.nn import quantized as tq
from bigdl_tpu_torch.models import lenet as tlenet
from bigdl_tpu_torch.nano.inference_optimizer import InferenceOptimizer as TIO
from bigdl_tpu_torch.utils.table import Table

TOL = dict(rtol=1e-4, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)
QTOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _np(tree):
    return jax.tree_util.tree_map(
        lambda a: a.detach().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a), tree)


def _input(spec, rs):
    """A shape → N(0, 1); ("mask", shape) → 0 / 1 floats; a list → a
    table."""
    if isinstance(spec, list):
        return [_input(s, rs) for s in spec]
    if spec[0] == "mask":
        return (rs.rand(*spec[1]) < 0.5).astype(np.float32)
    return rs.randn(*spec).astype(np.float32)


def _jax_in(x):
    return JTable(*[_jax_in(v) for v in x]) if isinstance(x, list) \
        else jnp.asarray(x)


def _torch_in(x):
    return Table(*[_torch_in(v) for v in x]) if isinstance(x, list) \
        else torch.from_numpy(np.array(x))


def _leaves(y):
    if isinstance(y, (Table, JTable, list, tuple)):
        return [leaf for v in y for leaf in _leaves(v)]
    return [np.asarray(y.detach() if isinstance(y, torch.Tensor) else y)]


def _close(got, want, what, tol=TOL):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        np.testing.assert_allclose(a, b, err_msg=what, **tol)


def _pair(build, rs):
    """The layer in both packages, the JAX module's parameters redrawn
    N(0, 0.5) (the peepholes start at 0) and carried to the port's."""
    jm, tm = build(jnn), build(tnn)
    p = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.5 * rs.randn(*a.shape).astype(np.float32)),
        jm.parameters_dict())
    jm.load_parameters_dict(p)
    tm.load_parameters_dict(_np(p))
    return jm, tm


def _kernel(rs, k):
    return np.abs(rs.randn(k, k)).astype(np.float32) + 0.1


IMG = (2, 3, 7, 8)
# (id, build(nn namespace), input spec)
LAYERS = [
    ("Reverse 1", lambda nn: nn.Reverse(1), (3, 4, 5)),
    ("Reverse 3", lambda nn: nn.Reverse(3), (3, 4, 5)),
    ("Tile", lambda nn: nn.Tile(2, 3), (2, 3, 4)),
    ("Pack 1", lambda nn: nn.Pack(1), [(2, 3)] * 3),
    ("Pack 3", lambda nn: nn.Pack(3), [(2, 3)] * 3),
    ("MaskedFill", lambda nn: nn.MaskedFill(-1.5),
     [(3, 4), ("mask", (3, 4))]),
    ("L1Penalty", lambda nn: nn.L1Penalty(0.1), (3, 4)),
    ("L1Penalty mean", lambda nn: nn.L1Penalty(0.1, size_average=True),
     (3, 4)),
    ("GradientReversal", lambda nn: nn.GradientReversal(0.7), (3, 4)),
    ("NarrowTable 1", lambda nn: nn.NarrowTable(2, 1), [(2, 3)] * 3),
    ("NarrowTable 2", lambda nn: nn.NarrowTable(2, 2), [(2, 3)] * 3),
    ("MixtureTable", lambda nn: nn.MixtureTable(),
     [(4, 3), [(4, 5), (4, 5), (4, 5)]]),
    ("MixtureTable 3-d", lambda nn: nn.MixtureTable(),
     [(4, 2), [(4, 3, 2), (4, 3, 2)]]),
    ("SubtractiveNorm", lambda nn: nn.SpatialSubtractiveNormalization(
        3, _kernel(np.random.RandomState(1), 5)), IMG),
    ("SubtractiveNorm NHWC", lambda nn: nn.SpatialSubtractiveNormalization(
        3, None, format="NHWC"), (2, 7, 8, 3)),
    ("DivisiveNorm", lambda nn: nn.SpatialDivisiveNormalization(
        3, _kernel(np.random.RandomState(2), 3)), IMG),
    ("DivisiveNorm NHWC", lambda nn: nn.SpatialDivisiveNormalization(
        3, _kernel(np.random.RandomState(2), 3), format="NHWC"),
     (2, 7, 8, 3)),
    ("ContrastiveNorm", lambda nn: nn.SpatialContrastiveNormalization(
        3, _kernel(np.random.RandomState(3), 5)), IMG),
    ("ConvLSTMPeephole", lambda nn: nn.ConvLSTMPeephole(2, 3, 3, 3),
     (2, 3, 2, 6, 5)),
    ("ConvLSTMPeephole stride 2", lambda nn: nn.ConvLSTMPeephole(
        2, 3, 3, 1, stride=2), (2, 3, 2, 7, 6)),
    ("ConvLSTM no peephole", lambda nn: nn.ConvLSTMPeephole(
        2, 4, 1, 3, with_peephole=False), (1, 2, 2, 5, 5)),
]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_extra2_forward_and_vjp(case):
    name, build, spec = case
    rs = np.random.RandomState(0)
    x = _input(spec, rs)
    jm, tm = _pair(build, rs)
    jp, js = jm.parameters_dict(), jm.states_dict()
    jx = _jax_in(x)

    def f(p, xi):
        return jm.apply(p, js, xi, training=True)[0]

    def run(p, xi, g):
        y, vjp = jax.vjp(f, p, xi)
        return y, vjp(g)

    out = jax.eval_shape(f, jp, jx)
    g = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)), out)
    jy, (gp, gx) = jax.jit(run)(jp, jx, g)
    tm.train()
    tx = _torch_in(x)
    ty = tm(tx)
    _close(ty, jy, f"{name}: forward")
    tg = [torch.from_numpy(np.array(v)) for v in _leaves(g)]
    gi = tm.backward(tx, tg if isinstance(ty, Table) else tg[0])
    _close(gi, gx, f"{name}: grad input", GTOL)
    want = _np(gp)
    for k, p in tm.parameters_dict().items():
        got = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        np.testing.assert_allclose(got, want[k], err_msg=f"{name}: d{k}",
                                   **GTOL)
    if hasattr(tm, "penalty_of"):
        np.testing.assert_allclose(
            float(tm.last_penalty), float(jm.penalty_of(jnp.asarray(x))),
            rtol=1e-6)


# -- nn.quantized.SpatialConvolution (Queue 3, fault 1) ----------------------------

CONVS = [
    ("plain", dict(), (2, 4, 9, 9)),
    ("SAME stride 2", dict(stride_w=2, stride_h=2, pad_w=-1, pad_h=-1),
     (2, 4, 9, 10)),
    ("groups 2 pad 1", dict(n_group=2, pad_w=1, pad_h=1), (2, 4, 8, 8)),
    ("dilation 2 no bias", dict(dilation_w=2, dilation_h=2,
                                with_bias=False), (2, 4, 11, 11)),
    ("NHWC SAME", dict(format="NHWC", pad_w=-1, pad_h=-1), (2, 9, 8, 4)),
]


def _states_equal(got, want, what):
    for k in ("q", "scale"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("case", CONVS, ids=[c[0] for c in CONVS])
def test_quantized_conv_from_float(case):
    name, kw, shape = case
    rs = np.random.RandomState(4)
    jc = jnn.SpatialConvolution(4, 6, 3, 3, **kw)
    tc = tnn.SpatialConvolution(4, 6, 3, 3, **kw)
    tc.load_parameters_dict(_np(jc.parameters_dict()))
    jm, tm = jq.SpatialConvolution.from_float(jc), \
        tq.SpatialConvolution.from_float(tc)
    _states_equal(tm.states_dict(), jm.states_dict(), name)
    x = rs.randn(*shape).astype(np.float32)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, err_msg=name, **QTOL)
    # the JAX twin's states and bias carried into another port twin
    other = tq.SpatialConvolution.from_float(
        tnn.SpatialConvolution(4, 6, 3, 3, **kw))
    other.load_states_dict(_np(jm.states_dict()))
    other.load_parameters_dict(_np(jm.parameters_dict()))
    _states_equal(other.states_dict(), jm.states_dict(), name)
    np.testing.assert_array_equal(
        other(torch.from_numpy(x)).detach().numpy(), got)


def test_quantize_model_swaps_convolutions():
    """``quantize_model(LeNet5())`` gives int8 convolutions and linears in
    both packages, with the same states and forward; a subclass of the
    float conv keeps its float weights, as in the JAX package; nano's
    ``_quantize_convs`` gives the same model."""
    jm = jlenet.build_model(10)
    tm = tlenet.build_model(10, device="cpu")
    tm.load_parameters_dict(_np(jm.parameters_dict()))
    x = np.random.RandomState(5).rand(4, 784).astype(np.float32)
    tnano = TIO._quantize_convs(tm, device="cpu")
    jq.quantize_model(jm)
    tq.quantize_model(tm)
    kinds = [type(m).__name__ + ("/q" if isinstance(
        m, (tq.Linear, tq.SpatialConvolution)) else "")
        for m in tm._modules.values()]
    assert kinds.count("SpatialConvolution/q") == 2, kinds
    assert kinds.count("Linear/q") == 2, kinds
    assert [type(m).__name__ for m in jm._modules.values()] == \
        [k.split("/")[0] for k in kinds]
    jst, tst = jm.states_dict(), tm.states_dict()
    assert set(jst) == set(tst)
    for k in jst:
        _states_equal(tst[k], jst[k], k)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **QTOL)
    np.testing.assert_array_equal(tnano(x), got)
    dil = tnn.Sequential().add(tnn.SpatialDilatedConvolution(1, 2, 3, 3))
    assert type(tq.quantize_model(dil)._modules["0"]) is \
        tnn.SpatialDilatedConvolution

"""The port's misc, recurrent, volumetric and extra3 layers and its
``nn.graph`` held to the JAX package on the CPU. Each case builds a
module in both packages, carries the JAX weights over, feeds the same
seeded numpy input and compares the output and the vjp (input and
parameter gradients) at rtol 1e-4 / atol 1e-5 (gradients 1e-4). The
random layers (``SpatialDropout1D`` / ``3D``, ``GaussianSampler``) are
held by contract: JAX's random streams are not reproduced. The graph
tests build one functional model in both packages, with the port's
node counter deliberately offset, and carry the weights by position."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import graph as jgraph
from bigdl_tpu.utils.table import Table as JTable

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.nn import graph as tgraph
from bigdl_tpu_torch.tensor import SparseTensor
from bigdl_tpu_torch.utils.table import Table

TOL = dict(rtol=1e-4, atol=1e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)


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
    """A shape → N(0, 1); ("idx", shape, n) → 1-based indices as floats;
    ("pos", shape) → positive; ("rois", n) → boxes; a list → a table."""
    if isinstance(spec, list):
        return [_input(s, rs) for s in spec]
    if spec[0] == "idx":
        return (rs.randint(0, spec[2], spec[1]) + 1).astype(np.float32)
    if spec[0] == "pos":
        return np.abs(rs.randn(*spec[1])).astype(np.float32) + 0.5
    if spec[0] == "rois":
        return np.array([[0, 1, 1, 4, 4], [1, 0, 2, 6, 5], [0, 2, 0, 3, 3],
                         [1, 3.5, 1.2, 5.7, 4.1]], np.float32)
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


def _grads(tm):
    def rec(d):
        return {k: rec(v) if isinstance(v, dict) else
                (np.zeros(v.shape, np.float32) if v.grad is None
                 else v.grad.numpy()) for k, v in d.items()}
    return rec(tm.parameters_dict())


def _assert_tree(got, want, what):
    want = {k: v for k, v in want.items()
            if not (isinstance(v, dict) and not v)}
    assert set(got) == set(want), (what, set(got), set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k], f"{what}.{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                       err_msg=f"{what}.{k}", **GTOL)


def _pair(build):
    jm, tm = build(jnn), build(tnn)
    tm.load_parameters_dict(_np(jm.parameters_dict()))
    tm.load_states_dict(_np(jm.states_dict()))
    return jm, tm


TABLE = [(2, 3, 4), (2, 3, 4)]
CONN = [[1, 1], [2, 1], [2, 2], [3, 2], [1, 3]]

# (id, build(nn namespace), input spec)
LAYERS = [
    # misc
    ("Max", lambda nn: nn.Max(2), (3, 4, 5)),
    ("Min", lambda nn: nn.Min(3), (3, 4, 5)),
    ("Mean", lambda nn: nn.Mean(2), (3, 4, 5)),
    ("Mean keep", lambda nn: nn.Mean(3, squeeze=False), (3, 4, 5)),
    ("Sum", lambda nn: nn.Sum(3), (3, 4, 5)),
    ("Index", lambda nn: nn.Index(2), [(3, 4, 5), ("idx", (6,), 4)]),
    ("MM", lambda nn: nn.MM(), [(2, 3, 4), (2, 4, 5)]),
    ("MM trans", lambda nn: nn.MM(True, True), [(2, 4, 3), (2, 5, 4)]),
    ("MV", lambda nn: nn.MV(), [(2, 3, 4), (2, 4)]),
    ("MV trans", lambda nn: nn.MV(True), [(2, 4, 3), (2, 4)]),
    ("DotProduct", lambda nn: nn.DotProduct(), TABLE),
    ("CosineDistance", lambda nn: nn.CosineDistance(), TABLE),
    ("PairwiseDistance", lambda nn: nn.PairwiseDistance(), TABLE),
    ("PairwiseDistance L1", lambda nn: nn.PairwiseDistance(1), TABLE),
    ("Euclidean", lambda nn: nn.Euclidean(5, 3), (4, 5)),
    ("Scale", lambda nn: nn.Scale((1, 5)), (4, 5)),
    ("TimeDistributed", lambda nn: nn.TimeDistributed(nn.Linear(4, 2)),
     (2, 3, 4)),
    ("Highway", lambda nn: nn.Highway(5), (4, 5)),
    ("Maxout", lambda nn: nn.Maxout(5, 3, 2), (4, 5)),
    ("SReLU", lambda nn: nn.SReLU((5,)), (4, 5)),
    ("LocallyConnected2D", lambda nn: nn.LocallyConnected2D(
        2, 6, 5, 3, 3, 2, 2, 1), (2, 2, 6, 5)),
    ("LocallyConnected2D no bias", lambda nn: nn.LocallyConnected2D(
        3, 5, 5, 2, 2, 2, with_bias=False), (2, 3, 5, 5)),
    # recurrent
    ("RnnCell", lambda nn: nn.RnnCell(3, 4), (2, 3)),
    ("LSTM cell", lambda nn: nn.LSTM(3, 4), (2, 3)),
    ("GRU cell", lambda nn: nn.GRU(3, 4), (2, 3)),
    ("Recurrent rnn", lambda nn: nn.Recurrent(nn.RnnCell(3, 4)), (2, 5, 3)),
    ("Recurrent rnn relu", lambda nn: nn.Recurrent(nn.RnnCell(
        3, 4, "relu")), (2, 5, 3)),
    ("Recurrent lstm", lambda nn: nn.Recurrent(nn.LSTM(3, 4)), (2, 5, 3)),
    ("Recurrent gru", lambda nn: nn.Recurrent(nn.GRU(3, 4)), (2, 5, 3)),
    ("Recurrent lstm last", lambda nn: nn.Recurrent(
        nn.LSTM(3, 4), return_sequences=False), (2, 5, 3)),
    ("Recurrent gru reverse", lambda nn: nn.Recurrent(
        nn.GRU(3, 4), reverse=True), (2, 5, 3)),
    ("Recurrent lstm reverse last", lambda nn: nn.Recurrent(
        nn.LSTM(3, 4), return_sequences=False, reverse=True), (2, 5, 3)),
    ("BiRecurrent concat", lambda nn: nn.BiRecurrent(
        nn.LSTM(3, 4), nn.LSTM(3, 4)), (2, 5, 3)),
    ("BiRecurrent sum", lambda nn: nn.BiRecurrent(
        nn.GRU(3, 4), nn.GRU(3, 4), "sum"), (2, 5, 3)),
    ("Recurrent MultiRNNCell", lambda nn: nn.Recurrent(nn.MultiRNNCell(
        [nn.LSTM(3, 4), nn.GRU(4, 5)])), (2, 4, 3)),
    ("MultiRNNCell", lambda nn: nn.MultiRNNCell(
        [nn.RnnCell(3, 4), nn.LSTM(4, 2)]), (2, 3)),
    # volumetric
    ("VolumetricConvolution", lambda nn: nn.VolumetricConvolution(
        2, 3, 3, 3, 3, 1, 1, 1, 1, 1, 1), (2, 2, 5, 5, 5)),
    ("VolumetricConvolution SAME s2", lambda nn: nn.VolumetricConvolution(
        2, 3, 3, 2, 3, 2, 2, 1, -1, -1, -1), (2, 2, 7, 6, 5)),
    ("VolumetricConvolution no bias", lambda nn: nn.VolumetricConvolution(
        2, 3, 2, 3, 1, 1, 2, 1, 0, 1, 0, with_bias=False), (1, 2, 4, 5, 6)),
    ("VolumetricFullConvolution", lambda nn: nn.VolumetricFullConvolution(
        2, 3, 3, 3, 3, 2, 2, 2, 1, 1, 1), (2, 2, 3, 3, 3)),
    ("VolumetricFullConvolution uneven", lambda nn:
     nn.VolumetricFullConvolution(2, 2, 2, 3, 4, 1, 2, 3, 0, 1, 2),
     (1, 2, 3, 4, 3)),
    ("VolumetricAveragePooling", lambda nn: nn.VolumetricAveragePooling(
        2, 2, 2), (2, 2, 4, 4, 4)),
    ("VolumetricAveragePooling pad", lambda nn: nn.VolumetricAveragePooling(
        3, 3, 2, 2, 2, 1, 1, 1, 0), (2, 2, 5, 6, 5)),
    ("VolumetricAveragePooling pad no-count", lambda nn:
     nn.VolumetricAveragePooling(3, 3, 2, 2, 2, 1, 1, 1, 0,
                                 count_include_pad=False), (2, 2, 5, 6, 5)),
    ("UpSampling3D", lambda nn: nn.UpSampling3D((2, 1, 3)), (2, 2, 2, 3, 2)),
    ("Cropping3D", lambda nn: nn.Cropping3D((1, 0), (0, 1), (1, 1)),
     (2, 2, 4, 4, 5)),
    ("Cropping2D", lambda nn: nn.Cropping2D((1, 1), (0, 2)), (2, 3, 5, 6)),
    # extra3
    ("HardShrink", lambda nn: nn.HardShrink(), (4, 5)),
    ("SoftShrink", lambda nn: nn.SoftShrink(0.3), (4, 5)),
    ("TanhShrink", lambda nn: nn.TanhShrink(), (4, 5)),
    ("LogSigmoid", lambda nn: nn.LogSigmoid(), (4, 5)),
    ("BinaryThreshold", lambda nn: nn.BinaryThreshold(0.1), (4, 5)),
    ("NegativeEntropyPenalty", lambda nn: nn.NegativeEntropyPenalty(0.1),
     ("pos", (4, 5))),
    ("ActivityRegularization", lambda nn: nn.ActivityRegularization(
        0.1, 0.2), (4, 5)),
    ("Cropping1D", lambda nn: nn.Cropping1D(1, 2), (2, 6, 3)),
    ("BifurcateSplitTable", lambda nn: nn.BifurcateSplitTable(2), (3, 7)),
    ("Input", lambda nn: nn.Input(), (3, 4)),
    ("ResizeBilinear up", lambda nn: nn.ResizeBilinear(7, 9), (2, 3, 4, 5)),
    ("ResizeBilinear down", lambda nn: nn.ResizeBilinear(4, 3),
     (2, 3, 9, 10)),
    ("ResizeBilinear mixed NHWC", lambda nn: nn.ResizeBilinear(
        3, 11, format="NHWC"), (2, 8, 5, 3)),
    ("ResizeBilinear down 1/3", lambda nn: nn.ResizeBilinear(5, 4),
     (1, 2, 15, 12)),
    ("ResizeBilinear align up", lambda nn: nn.ResizeBilinear(
        7, 9, align_corners=True), (2, 3, 4, 5)),
    ("ResizeBilinear align down NHWC", lambda nn: nn.ResizeBilinear(
        3, 1, align_corners=True, format="NHWC"), (2, 9, 6, 2)),
    ("RoiPooling", lambda nn: nn.RoiPooling(2, 3, 0.5),
     [(2, 6, 7, 3), ("rois", 4)]),
    ("SpatialShareConvolution", lambda nn: nn.SpatialShareConvolution(
        3, 4, 3, 3, 1, 1, 1, 1), (2, 3, 6, 6)),
    ("SpatialConvolutionMap", lambda nn: nn.SpatialConvolutionMap(
        CONN, 3, 3, 1, 1, 1, 1), (2, 3, 6, 6)),
    ("SpatialConvolutionMap s2", lambda nn: nn.SpatialConvolutionMap(
        CONN, 3, 2, 2, 1), (2, 3, 7, 6)),
    ("PriorBox", lambda nn: nn.PriorBox([30.0], [60.0], (2.0, 3.0),
                                         clip=True), (1, 4, 3, 3)),
    ("Anchor", lambda nn: nn.Anchor(16, (32., 64.)), (1, 2, 3, 4)),
]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_forward_and_vjp(case):
    name, build, spec = case
    rs = np.random.RandomState(0)
    x = _input(spec, rs)
    jm, tm = _pair(build)
    jp, js = jm.parameters_dict(), jm.states_dict()
    jx = _jax_in(x)
    out = jax.eval_shape(lambda p, xi: jm.apply(p, js, xi,
                                                training=True)[0], jp, jx)
    g = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)), out)

    def run(p, xi, g):
        y = jm.apply(p, js, xi, training=True)[0]
        _, vjp = jax.vjp(lambda p, xi: jm.apply(p, js, xi,
                                                training=True)[0], p, xi)
        return y, vjp(g)

    jy, (gp, gx) = jax.jit(run)(jp, jx, g)
    tm.train()
    tx = _torch_in(x)
    ty = tm(tx)
    _close(ty, jy, f"{name}: forward")
    tg = [torch.from_numpy(np.array(v)) for v in _leaves(g)]
    gi = tm.backward(tx, tg if isinstance(ty, list) else tg[0])
    _close(gi, gx, f"{name}: grad input", GTOL)
    _assert_tree(_grads(tm), _np(gp), f"{name}: grad params")
    if hasattr(tm, "penalty_of"):          # the recorded penalty
        np.testing.assert_allclose(
            float(tm.last_penalty),
            float(jm.penalty_of(jnp.asarray(x))), rtol=1e-5)


def test_cosine_distance_on_tiny_rows_is_the_jax_nn_one():
    """``nn.CosineDistance`` is misc.py's (the dot over the product of
    the norms plus 1e-12), as the JAX ``nn`` exports it, also where rows
    of norm 1e-7 make the containers' version differ 100-fold."""
    rs = np.random.RandomState(3)
    a, b = (rs.randn(4, 6).astype(np.float32) for _ in range(2))
    a *= 1e-7 / np.linalg.norm(a, axis=1, keepdims=True)
    b *= 1e-7 / np.linalg.norm(b, axis=1, keepdims=True)
    want = np.asarray(jnn.CosineDistance().forward(JTable(a, b)))
    got = tnn.CosineDistance()(Table(torch.from_numpy(a),
                                     torch.from_numpy(b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    for name in ("CosineDistance", "DotProduct", "MM", "MV"):
        assert getattr(tnn, name).__module__.endswith("layers.misc")


def test_masked_select_and_dense_to_sparse():
    rs = np.random.RandomState(1)
    x = rs.randn(3, 4).astype(np.float32)
    mask = (rs.rand(3, 4) > 0.5).astype(np.float32)
    want = np.asarray(jnn.MaskedSelect().forward(JTable(x, mask)))
    tx = torch.from_numpy(x).requires_grad_()
    got = tnn.MaskedSelect()(Table(tx, torch.from_numpy(mask)))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()                       # the mask scattered back
    np.testing.assert_array_equal(tx.grad.numpy(), mask)
    x[x < 0.3] = 0.0
    js = jnn.DenseToSparse().forward(jnp.asarray(x))
    ts = tnn.DenseToSparse()(torch.from_numpy(x))
    assert isinstance(ts, SparseTensor) and ts.shape == js.shape
    assert ts.indices.dtype == torch.int32
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_array_equal(ts.values.numpy(), np.asarray(js.values))
    np.testing.assert_array_equal(ts.to_dense().numpy(),
                                  np.asarray(js.to_dense()))


@pytest.mark.parametrize("kind", ["1D", "3D NCDHW", "3D NDHWC"])
def test_spatial_dropout_contract(kind):
    """Whole channels dropped at the keep rate, survivors scaled by
    1 / keep; the same mask in forward and backward; the same seed gives
    the same output; the identity in eval mode and at p = 0; the JAX
    layer's shapes."""
    shape, build = {
        "1D": ((64, 8, 32), lambda g: tnn.SpatialDropout1D(0.3, g)),
        "3D NCDHW": ((64, 32, 2, 3, 2), lambda g: tnn.SpatialDropout3D(
            0.3, generator=g)),
        "3D NDHWC": ((64, 2, 3, 2, 32), lambda g: tnn.SpatialDropout3D(
            0.3, "NDHWC", g))}[kind]
    d = build(torch.Generator().manual_seed(5))
    x = torch.ones(shape)
    y = d.train()(x)
    assert set(torch.unique(y).tolist()) <= {0.0, (x / 0.7).max().item()}
    chan = (1, 4) if kind == "1D" else ((1, 32) if "NC" in kind
                                        else (4, 32))
    per = y.amax(dim=tuple(i for i in range(1, y.dim())
                           if y.shape[i] != 32))
    assert per.shape == (64, 32)
    assert bool(((y == 0) == (per == 0).reshape(
        (64,) + tuple(32 if s == 32 else 1 for s in shape[1:]))).all()), chan
    assert abs(float((per == 0).float().mean()) - 0.3) < 0.05
    gi = d.backward(x, torch.ones_like(x))
    torch.testing.assert_close(gi, y)
    torch.testing.assert_close(build(torch.Generator().manual_seed(5))
                               .train()(x), y)
    assert d.eval()(x) is x
    j = (jnn.SpatialDropout1D(0.3) if kind == "1D" else
         jnn.SpatialDropout3D(0.3, kind[3:]))
    jy, _ = j.apply({}, {}, jnp.ones(shape), training=True,
                    rng=jax.random.PRNGKey(0))
    assert jy.shape == y.shape
    assert set(np.unique(np.asarray(jy)).tolist()) <= {
        0.0, (x / 0.7).max().item()}


def test_gaussian_sampler_contract():
    """mean + exp(log_var / 2) * eps, eps ~ N(0, 1) from the layer's
    generator: the moments, the gradient through the sample, the same
    seed giving the same draw, the JAX layer's shape."""
    rs = np.random.RandomState(2)
    mean = torch.from_numpy(rs.randn(4000, 3).astype(np.float32))
    log_var = torch.from_numpy(np.log(np.full((4000, 3), 0.25, np.float32)))
    s = tnn.GaussianSampler(torch.Generator().manual_seed(7))
    y = s(Table(mean, log_var))
    eps = (y - mean) / 0.5
    assert abs(float(eps.mean())) < 0.05 and abs(float(eps.std()) - 1) < 0.05
    again = tnn.GaussianSampler(torch.Generator().manual_seed(7))
    torch.testing.assert_close(again(Table(mean, log_var)), y)
    gm, gv = s.backward(Table(mean, log_var), torch.ones_like(y))
    torch.testing.assert_close(gm, torch.ones_like(mean))
    torch.testing.assert_close(gv, 0.5 * 0.5 * eps)     # d/dlv = s/2 * eps
    jy = jnn.GaussianSampler().forward(JTable(jnp.asarray(mean.numpy()),
                                              jnp.asarray(log_var.numpy())))
    assert jy.shape == tuple(y.shape)


# -- nn.graph --------------------------------------------------------------------

def _functional(nn, graph):
    """Two inputs → Linear / BN / Tanh and Linear branches → concat and
    a sum → Linear; the first input's Linear shared by two nodes."""
    a, b = graph.Input(), graph.Input("b")
    shared = nn.Linear(4, 3)
    ha = nn.Tanh().inputs(nn.BatchNormalization(3).inputs(shared.inputs(a)))
    hb = nn.Linear(5, 3).inputs(b)
    cat = nn.JoinTable(2, 2).inputs(ha, hb)
    s = nn.CAddTable().inputs([hb, shared.inputs(a)])
    out = nn.Linear(6, 2).inputs(cat)
    return graph.Graph([a, b], [out, s]), (a, b, out)


def test_graph_carries_jax_weights_by_position(tmp_path):
    jg, _ = _functional(jnn, jgraph)
    tgraph.Node._counter[0] += 1000              # other node keys
    tg, _ = _functional(tnn, tgraph)
    assert set(tg.parameters_dict()) != set(jg.parameters_dict())
    rs = np.random.RandomState(4)
    xa, xb = rs.randn(6, 4).astype(np.float32), rs.randn(6, 5).astype(
        np.float32)
    jg.load_states_dict(jax.tree_util.tree_map(
        lambda v: jnp.asarray(rs.rand(*v.shape).astype(np.float32) + .5),
        jg.states_dict()))
    jy, _ = jg.apply(jg.parameters_dict(), jg.states_dict(),
                     [jnp.asarray(xa), jnp.asarray(xb)], training=False)
    order = [n.name for n in jg._order]
    for how in ("node number", "order", "checkpoint"):
        t2, _ = _functional(tnn, tgraph)
        if how == "checkpoint":
            jg.save_weights(str(tmp_path / "g"))
            with pytest.raises(ValueError, match="do not match"):
                t2.load_weights(str(tmp_path / "g"))   # strict: exact keys
            t2.load_weights(str(tmp_path / "g"), strict=False)
        else:
            kw = {"order": order} if how == "order" else {}
            t2.load_parameters_dict(_np(jg.parameters_dict()), **kw)
            t2.load_states_dict(_np(jg.states_dict()), **kw)
        t2.eval()
        for arg in ([torch.from_numpy(xa), torch.from_numpy(xb)],
                    Table(torch.from_numpy(xa), torch.from_numpy(xb))):
            _close(t2(arg), jy, f"graph carried by {how}")
    with pytest.raises(ValueError, match="expects 2 inputs"):
        t2(torch.from_numpy(xa))


def test_graph_vjp_and_errors():
    jg, _ = _functional(jnn, jgraph)
    tg, _ = _functional(tnn, tgraph)
    tg.load_parameters_dict(_np(jg.parameters_dict()))
    tg.load_states_dict(_np(jg.states_dict()))
    rs = np.random.RandomState(5)
    x = [rs.randn(6, 4).astype(np.float32), rs.randn(6, 5).astype(np.float32)]
    g = [rs.randn(6, 2).astype(np.float32), rs.randn(6, 3).astype(np.float32)]
    jp, js = jg.parameters_dict(), jg.states_dict()
    jy, vjp = jax.vjp(lambda p, xi: jg.apply(p, js, xi, training=True)[0],
                      jp, [jnp.asarray(v) for v in x])
    gp, gx = vjp([jnp.asarray(v) for v in g])
    tx = [torch.from_numpy(v) for v in x]
    _close(tg.train()(tx), jy, "graph forward")
    gi = tg.backward(tx, [torch.from_numpy(v) for v in g])
    _close(gi, gx, "graph grad input", GTOL)
    # the shared Linear is one module here: its gradient is the sum of
    # the JAX copies' at its two nodes
    want = tg.carry_keys(_np(gp))
    by_module = {}
    for k, m in tg._modules.items():
        by_module.setdefault(id(m), []).append(k)
    (shared,) = [ks for ks in by_module.values() if len(ks) == 2]
    total = jax.tree_util.tree_map(np.add, *[want[k] for k in shared])
    want.update({k: total for k in shared})
    _assert_tree(_grads(tg), want, "graph grad params")
    # a cycle, an unreachable input, a tree of another shape
    a = tgraph.Input()
    n1 = tnn.Linear(4, 4).inputs(a)
    n1.inputs.append(n1)
    with pytest.raises(ValueError, match="cycle"):
        tgraph.Graph([a], [n1])
    b, c = tgraph.Input(), tgraph.Input()
    with pytest.raises(ValueError, match="unreachable"):
        tgraph.Graph([b, c], [tnn.Tanh().inputs(b)])
    with pytest.raises(ValueError, match="nodes with params"):
        tg.load_parameters_dict({"Linear9_node1": {}})

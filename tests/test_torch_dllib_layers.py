"""The port's DLlib layers, containers, criterions and checkpoint format
held to the JAX package on the CPU: each case builds a module in both
packages, carries the JAX weights and states over, feeds the same
seeded numpy input, and compares the output, the running statistics
and the vjp (input and parameter gradients) in f32 at rtol 1e-4 / atol
1e-5; criterions compare the loss and its input gradient. Dropout is
checked by contract (rate, scaling, one mask in forward and backward):
JAX's random streams are not reproduced."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as _jnn
import bigdl_tpu.nn.containers as _jcont
from bigdl_tpu.utils import checkpoint as jckpt
from bigdl_tpu.utils.table import Table as JTable

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.nn.module import Module as TModule, replay_state
from bigdl_tpu_torch.utils import checkpoint as tckpt
from bigdl_tpu_torch.utils.table import Table

JNN = types.SimpleNamespace(**{k: getattr(_jnn, k) for k in dir(_jnn)})
for _k in ("MM", "MV", "DotProduct", "CosineDistance"):
    setattr(JNN, _k, getattr(_jcont, _k))
TOL = dict(rtol=1e-4, atol=1e-5)


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
    """A shape → N(0, 1); ("pos", shape) → positive; a list → a table."""
    if isinstance(spec, list):
        return [_input(s, rs) for s in spec]
    if spec[0] == "pos":
        return np.abs(rs.randn(*spec[1])).astype(np.float32) + 0.5
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
        np.testing.assert_allclose(a, b, err_msg=what, **tol)


def _grads(tm):
    def rec(d):
        return {k: rec(v) if isinstance(v, dict) else
                (np.zeros(v.shape, np.float32) if v.grad is None
                 else v.grad.numpy()) for k, v in d.items()}
    return rec(tm.parameters_dict())


def _assert_tree(got, want, what):
    want = {k: v for k, v in want.items() if v is not None and not (
        isinstance(v, dict) and not v)}         # the JAX trees' empty scopes
    assert set(got) == set(want), (what, set(got), set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(got[k], want[k], f"{what}.{k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                       err_msg=f"{what}.{k}", **TOL)


def _pair(build, random_stats=False):
    jm, tm = build(JNN), build(tnn)
    states = jm.states_dict()
    if random_stats:
        rs = np.random.RandomState(7)
        states = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rs.rand(*a.shape).astype(np.float32) + .5),
            states)
        jm.load_states_dict(states)
    tm.load_parameters_dict(_np(jm.parameters_dict()))
    tm.load_states_dict(_np(states))
    return jm, tm


def _bn(n, **kw):
    return lambda nn: nn.Sequential().add(
        nn.SpatialConvolution(3, n, 3, 3, 2, 2, -1, -1, **kw)).add(
        nn.SpatialBatchNormalization(n, **kw)).add(nn.ReLU())


# (id, build(nn namespace), input spec, training mode, random running stats)
LAYERS = [
    ("Linear", lambda nn: nn.Linear(5, 3), (4, 5), True, False),
    ("Bilinear", lambda nn: nn.Bilinear(3, 4, 2), [(5, 3), (5, 4)], True, False),
    ("CMul", lambda nn: nn.CMul((1, 5)), (4, 5), True, False),
    ("CAdd", lambda nn: nn.CAdd((5,)), (4, 5), True, False),
    ("Add", lambda nn: nn.Add(5), (4, 5), True, False),
    ("Mul", lambda nn: nn.Mul(), (4, 5), True, False),
    ("Cosine", lambda nn: nn.Cosine(5, 3), (4, 5), True, False),
    ("conv", lambda nn: nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1),
     (2, 3, 7, 7), True, False),
    ("conv7x7s2 SAME", lambda nn: nn.SpatialConvolution(
        3, 4, 7, 7, 2, 2, -1, -1), (2, 3, 16, 16), True, False),
    ("conv7x7s2 SAME NHWC", lambda nn: nn.SpatialConvolution(
        3, 4, 7, 7, 2, 2, -1, -1, format="NHWC"), (2, 16, 16, 3), True,
     False),
    ("conv3x3s2 SAME", lambda nn: nn.SpatialConvolution(
        3, 4, 3, 3, 2, 2, -1, -1, with_bias=False), (2, 3, 8, 8), True,
     False),
    ("conv groups", lambda nn: nn.SpatialConvolution(
        4, 6, 3, 3, 2, 1, 0, 1, n_group=2), (2, 4, 7, 6), True, False),
    ("dilated conv", lambda nn: nn.SpatialDilatedConvolution(
        3, 4, 3, 3, 1, 1, 2, 2, 2, 2), (2, 3, 9, 9), True, False),
    ("full conv", lambda nn: nn.SpatialFullConvolution(
        3, 4, 3, 3, 2, 2, 1, 1, 1, 1), (2, 3, 5, 5), True, False),
    ("full conv NHWC adj", lambda nn: nn.SpatialFullConvolution(
        3, 2, 3, 3, 2, 2, 0, 0, 2, 1, format="NHWC"), (2, 4, 5, 3), True,
     False),
    ("separable conv", lambda nn: nn.SpatialSeparableConvolution(
        3, 5, 2, 3, 3, 1, 1, 1, 1), (2, 3, 6, 6), True, False),
    ("temporal conv SAME", lambda nn: nn.TemporalConvolution(
        4, 3, 3, 2, pad=-1), (2, 8, 4), True, False),
    ("temporal conv dilated", lambda nn: nn.TemporalConvolution(
        4, 3, 3, 1, pad=1, dilation=2), (2, 9, 4), True, False),
    ("LocallyConnected1D", lambda nn: nn.LocallyConnected1D(
        7, 3, 4, 3, 2), (2, 7, 3), True, False),
    ("maxpool SAME (ResNet)", lambda nn: nn.SpatialMaxPooling(
        3, 3, 2, 2, -1, -1), (2, 3, 8, 8), True, False),
    ("maxpool SAME NHWC", lambda nn: nn.SpatialMaxPooling(
        3, 3, 2, 2, -1, -1, format="NHWC"), (2, 7, 8, 3), True, False),
    ("maxpool ceil", lambda nn: nn.SpatialMaxPooling(
        3, 3, 2, 2, 1, 0).ceil(), (2, 3, 8, 7), True, False),
    ("avgpool ceil no-pad-count", lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, 1, 1, ceil_mode=True, count_include_pad=False),
     (2, 3, 8, 7), True, False),
    ("avgpool SAME", lambda nn: nn.SpatialAveragePooling(
        3, 3, 2, 2, -1, -1), (2, 3, 7, 8), True, False),
    ("avgpool global", lambda nn: nn.SpatialAveragePooling(
        2, 2, global_pooling=True, format="NHWC"), (2, 5, 4, 3), True,
     False),
    ("avgpool sum", lambda nn: nn.SpatialAveragePooling(
        2, 2, 1, 1, divide=False), (2, 3, 5, 5), True, False),
    ("TemporalMaxPooling", lambda nn: nn.TemporalMaxPooling(2), (2, 8, 3),
     True, False),
    ("GlobalAveragePooling2D", lambda nn: nn.GlobalAveragePooling2D(),
     (2, 3, 4, 5), True, False),
    ("GlobalAveragePooling2D NHWC", lambda nn: nn.GlobalAveragePooling2D(
        format="NHWC", keep_dims=True), (2, 4, 5, 3), True, False),
    ("GlobalMaxPooling2D", lambda nn: nn.GlobalMaxPooling2D(), (2, 3, 4, 5),
     True, False),
    ("VolumetricMaxPooling", lambda nn: nn.VolumetricMaxPooling(
        2, 2, 2, pad_t=1), (2, 2, 4, 4, 4), True, False),
    ("BN train", lambda nn: nn.BatchNormalization(4), (6, 4), True, False),
    ("BN train 3-d", lambda nn: nn.BatchNormalization(4, momentum=0.3),
     (6, 4, 5), True, True),
    ("BN eval", lambda nn: nn.BatchNormalization(4), (6, 4), False, True),
    ("spatial BN train", lambda nn: nn.SpatialBatchNormalization(3),
     (4, 3, 5, 5), True, True),
    ("spatial BN train NHWC", lambda nn: nn.SpatialBatchNormalization(
        3, format="NHWC"), (4, 5, 5, 3), True, True),
    ("spatial BN eval NHWC", lambda nn: nn.SpatialBatchNormalization(
        3, format="NHWC"), (4, 5, 5, 3), False, True),
    ("spatial BN no affine", lambda nn: nn.SpatialBatchNormalization(
        3, affine=False), (4, 3, 5, 5), True, False),
    ("conv+BN+ReLU NCHW", _bn(4), (4, 3, 8, 8), True, True),
    ("conv+BN+ReLU NHWC", _bn(4, format="NHWC"), (4, 8, 8, 3), True, True),
    ("GroupNorm", lambda nn: nn.GroupNorm(2, 4), (2, 4, 3, 3), True, False),
    ("GroupNorm NHWC", lambda nn: nn.GroupNorm(2, 4, format="NHWC"),
     (2, 3, 3, 4), True, False),
    ("RMSNorm", lambda nn: nn.RMSNorm(5), (3, 5), True, False),
    ("LayerNorm", lambda nn: nn.LayerNorm(5), (3, 5), True, False),
    ("Normalize", lambda nn: nn.Normalize(2.0), (3, 5), True, False),
    ("Normalize inf", lambda nn: nn.Normalize(float("inf")), (3, 5), True,
     False),
    ("SpatialCrossMapLRN", lambda nn: nn.SpatialCrossMapLRN(3, 0.5),
     (2, 5, 3, 3), True, False),
    ("SpatialCrossMapLRN NHWC", lambda nn: nn.SpatialCrossMapLRN(
        4, format="NHWC"), (2, 3, 3, 5), True, False),
    ("SpatialWithinChannelLRN", lambda nn: nn.SpatialWithinChannelLRN(3),
     (2, 2, 5, 5), True, False),
] + [(n, (lambda n: lambda nn: getattr(nn, n)())(n), (3, 5), True, False)
     for n in ("Identity", "ReLU", "ReLU6", "Tanh", "Sigmoid", "HardSigmoid",
               "HardTanh", "ELU", "SELU", "GELU", "SiLU", "Mish", "LeakyReLU",
               "PReLU", "SoftMax", "LogSoftMax", "SoftMin", "SoftPlus",
               "SoftSign", "Threshold", "Square", "Exp", "Abs", "Negative",
               "Swish")] + [
    ("PReLU planes", lambda nn: nn.PReLU(3), (2, 3, 2, 2), True, False),
    ("RReLU eval", lambda nn: nn.RReLU(), (3, 5), False, False),
    ("GELU exact", lambda nn: nn.GELU(approximate=False), (3, 5), True,
     False),
    ("SoftMax pos", lambda nn: nn.SoftMax(1), (3, 5, 2), True, False),
    ("Power", lambda nn: nn.Power(1.5, 2.0, 0.5), ("pos", (3, 5)), True,
     False),
    ("Sqrt", lambda nn: nn.Sqrt(), ("pos", (3, 5)), True, False),
    ("Log", lambda nn: nn.Log(), ("pos", (3, 5)), True, False),
    ("Clamp", lambda nn: nn.Clamp(-0.5, 0.5), (3, 5), True, False),
    ("AddConstant", lambda nn: nn.AddConstant(1.5), (3, 5), True, False),
    ("MulConstant", lambda nn: nn.MulConstant(-2.0), (3, 5), True, False),
    ("Reshape", lambda nn: nn.Reshape([5, 4]), (3, 20), True, False),
    ("Reshape no batch", lambda nn: nn.Reshape([4, 15], False), (3, 20),
     True, False),
    ("InferReshape", lambda nn: nn.InferReshape([-1, 10]), (3, 20), True,
     False),
    ("View", lambda nn: nn.View(4, 5), (3, 2, 10), True, False),
    ("Flatten", lambda nn: nn.Flatten(), (3, 4, 5), True, False),
    ("Squeeze", lambda nn: nn.Squeeze(2), (3, 1, 5), True, False),
    ("Unsqueeze", lambda nn: nn.Unsqueeze(2), (3, 5), True, False),
    ("Transpose", lambda nn: nn.Transpose([(1, 3), (2, 3)]), (2, 3, 4),
     True, False),
    ("Permute", lambda nn: nn.Permute([3, 1, 2]), (2, 3, 4, 5), True, False),
    ("Contiguous", lambda nn: nn.Contiguous(), (3, 5), True, False),
    ("Select", lambda nn: nn.Select(2, -1), (3, 4, 5), True, False),
    ("Narrow", lambda nn: nn.Narrow(2, 2, -1), (3, 6), True, False),
    ("Padding before", lambda nn: nn.Padding(1, -2, 1, 0.5), (3, 4), True,
     False),
    ("Padding after", lambda nn: nn.Padding(2, 3), (3, 4), True, False),
    ("SpatialZeroPadding", lambda nn: nn.SpatialZeroPadding(1, 2, 0, 3),
     (2, 3, 4, 4), True, False),
    ("SpatialZeroPadding NHWC", lambda nn: nn.SpatialZeroPadding(
        2, format="NHWC"), (2, 4, 4, 3), True, False),
    ("Replicate", lambda nn: nn.Replicate(3, 2), (2, 4), True, False),
    ("UpSampling2D", lambda nn: nn.UpSampling2D((2, 3)), (2, 3, 2, 2), True,
     False),
    ("UpSampling1D", lambda nn: nn.UpSampling1D(2), (2, 3, 4), True, False),
    ("Sequential", lambda nn: nn.Sequential().add(nn.Linear(5, 4)).add(
        nn.Tanh()).add(nn.Linear(4, 2)), (3, 5), True, False),
    ("Concat", lambda nn: nn.Concat(2).add(nn.Linear(5, 2)).add(
        nn.Linear(5, 3)), (3, 5), True, False),
    ("ConcatTable+CAddTable", lambda nn: nn.Sequential().add(
        nn.ConcatTable().add(nn.Linear(5, 3)).add(nn.Linear(5, 3))).add(
        nn.CAddTable()), (3, 5), True, False),
    ("ParallelTable", lambda nn: nn.ParallelTable().add(nn.Linear(5, 2)).add(
        nn.Tanh()), [(3, 5), (3, 4)], True, False),
    ("MapTable", lambda nn: nn.MapTable(nn.Linear(4, 2)),
     [(3, 4), (3, 4)], True, False),
    ("Bottle", lambda nn: nn.Bottle(nn.Linear(4, 2)), (2, 3, 4), True,
     False),
    ("Checkpoint(BN)", lambda nn: nn.Sequential().add(nn.Checkpoint(
        nn.Sequential().add(nn.Linear(5, 4)).add(
            nn.BatchNormalization(4)).add(nn.Tanh()))).add(
        nn.Linear(4, 2)), (6, 5), True, True),
] + [(n, (lambda n: lambda nn: getattr(nn, n)())(n), [(3, 4), (3, 4)],
      True, False)
     for n in ("CMulTable", "CSubTable", "CMaxTable", "CMinTable",
               "CAveTable", "DotProduct", "CosineDistance")] + [
    ("CDivTable", lambda nn: nn.CDivTable(), [(3, 4), ("pos", (3, 4))],
     True, False),
    ("MM", lambda nn: nn.MM(True, False), [(2, 4, 3), (2, 4, 5)], True,
     False),
    ("MV", lambda nn: nn.MV(True), [(2, 4, 3), (2, 4)], True, False),
    ("SelectTable", lambda nn: nn.SelectTable(-1), [(3, 4), (3, 2)], True,
     False),
    ("FlattenTable", lambda nn: nn.FlattenTable(),
     [(3, 4), [(3, 2), (3, 1)]], True, False),
    ("JoinTable", lambda nn: nn.JoinTable(2, 2), [(3, 4), (3, 2)], True,
     False),
    ("SplitTable", lambda nn: nn.SplitTable(2), (3, 4, 2), True, False),
]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_layer_forward_and_vjp(case):
    name, build, spec, training, random_stats = case
    rs = np.random.RandomState(0)
    x = _input(spec, rs)
    jm, tm = _pair(build, random_stats)
    jp, js = jm.parameters_dict(), jm.states_dict()
    jx = _jax_in(x)
    out = jax.eval_shape(lambda p, xi: jm.apply(p, js, xi,
                                                training=training)[0], jp, jx)
    g = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.randn(*a.shape).astype(np.float32)), out)

    def run(p, xi, g):
        y, ns = jm.apply(p, js, xi, training=training)
        _, vjp = jax.vjp(lambda p, xi: jm.apply(p, js, xi,
                                                training=training)[0], p, xi)
        return y, ns, vjp(g)

    # one compile a case (eager JAX compiles op by op); the JAX
    # within-channel LRN builds its init value from x's dtype, eager only
    jy, jns, (gp, gx) = (run if name == "SpatialWithinChannelLRN"
                         else jax.jit(run))(jp, jx, g)

    tm.train(training)
    tx = _torch_in(x)
    _close(tm(tx), jy, f"{name}: forward")
    gi = tm.backward(tx, _torch_in(_leaves(g)) if isinstance(
        jy, JTable) else torch.from_numpy(np.array(g)))
    _assert_tree(_np(tm.states_dict()), _np(jns), f"{name}: states")
    _close(gi, gx, f"{name}: grad input", dict(rtol=1e-4, atol=1e-4))
    _assert_tree(_grads(tm), _np(gp), f"{name}: grad params")


def test_masking():
    x = np.random.RandomState(0).randn(2, 4, 3).astype(np.float32)
    x[:, 1] = 0.0
    _close(tnn.Masking()(torch.from_numpy(x)),
           JNN.Masking().forward(jnp.asarray(x)), "Masking")


def test_backward_accumulates_and_zero_grad():
    m = tnn.Linear(3, 2)
    x, g = torch.randn(4, 3), torch.randn(4, 2)
    m.backward(x, g)
    first = m.weight.grad.clone()
    m.backward(x, g)
    torch.testing.assert_close(m.weight.grad, 2 * first)
    w, gw = m.zero_grad_parameters().weights_and_grads()
    assert [t.shape for t in w] == [(2,), (2, 3)]        # bias, weight
    assert all(float(t.abs().sum()) == 0 for t in gw)


def test_dropout_contract():
    """Rate and 1/keep scaling; the same mask in forward and backward;
    the same seed gives the same output; the identity in eval."""
    d = tnn.Dropout(0.3, generator=torch.Generator().manual_seed(3))
    x = torch.ones(128, 128)
    y = d.train()(x)
    assert set(torch.unique(y).tolist()) <= {0.0, (x / 0.7)[0, 0].item()}
    assert abs((y == 0).float().mean().item() - 0.3) < 0.02
    gi = d.backward(x, torch.ones_like(x))
    torch.testing.assert_close(gi, y)                  # mask == dy/dx
    again = tnn.Dropout(0.3, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(again.train()(x), y)
    nxt = d(x)
    assert not torch.equal(nxt, y)     # the stream moved on once, not twice
    assert d.eval()(x) is x


def test_checkpoint_replays_dropout_and_moves_stats_once():
    block = tnn.Sequential().add(tnn.Linear(5, 4)).add(
        tnn.BatchNormalization(4)).add(tnn.Dropout(0.5))
    plain = tnn.Sequential().add(tnn.Linear(5, 4)).add(
        tnn.BatchNormalization(4)).add(tnn.Dropout(0.5))
    plain.load_parameters_dict(block.parameters_dict())
    for m in (block, plain):
        m[2].generator = torch.Generator().manual_seed(1)
    remat = tnn.Checkpoint(block)
    x = torch.randn(8, 5, requires_grad=True)
    y1 = remat(x)
    y1.sum().backward()
    g1 = x.grad.clone()
    x.grad = None
    y2 = plain(x)
    y2.sum().backward()
    torch.testing.assert_close(y1, y2)
    torch.testing.assert_close(g1, x.grad)
    torch.testing.assert_close(block[1].running_mean, plain[1].running_mean)
    with replay_state(plain):
        plain(x)
    torch.testing.assert_close(block[1].running_mean, plain[1].running_mean)


# -- criterions -----------------------------------------------------------------

def _labels(rs, n=6, c=5):
    return (rs.randint(0, c, n) + 1).astype(np.float32)


CRITERIA = [
    ("ClassNLL", lambda nn: nn.ClassNLLCriterion(), "logp", "label"),
    ("ClassNLL weighted", lambda nn: nn.ClassNLLCriterion(
        weights=np.arange(1, 6, dtype=np.float32)), "logp", "label"),
    ("ClassNLL zero-based sum", lambda nn: nn.ClassNLLCriterion(
        size_average=False, zero_based_label=True), "logp", "label0"),
    ("ClassNLL probs", lambda nn: nn.ClassNLLCriterion(
        logProbAsInput=False), "prob", "label"),
    ("CrossEntropy", lambda nn: nn.CrossEntropyCriterion(), "x", "label"),
    ("CrossEntropy weighted", lambda nn: nn.CrossEntropyCriterion(
        weights=np.linspace(.5, 2, 5).astype(np.float32)), "x", "label"),
    ("CategoricalCrossEntropy", lambda nn: nn.CategoricalCrossEntropy(),
     "prob", "onehot"),
    ("MSE", lambda nn: nn.MSECriterion(), "x", "x"),
    ("Abs sum", lambda nn: nn.AbsCriterion(False), "x", "x"),
    ("SmoothL1", lambda nn: nn.SmoothL1Criterion(sigma=2.0), "x", "x"),
    ("BCE", lambda nn: nn.BCECriterion(
        weights=np.linspace(.5, 1.5, 5).astype(np.float32)), "prob01",
     "bits"),
    ("BCEWithLogits", lambda nn: nn.BCEWithLogitsCriterion(), "x", "bits"),
    ("DistKLDiv", lambda nn: nn.DistKLDivCriterion(), "logp", "prob"),
    ("Margin squared", lambda nn: nn.MarginCriterion(0.5, squared=True),
     "x", "sign"),
    ("MarginRanking", lambda nn: nn.MarginRankingCriterion(0.3), "pairv",
     "sign1"),
    ("HingeEmbedding", lambda nn: nn.HingeEmbeddingCriterion(), "x", "sign"),
    ("CosineEmbedding", lambda nn: nn.CosineEmbeddingCriterion(0.1), "pair",
     "sign1"),
    ("SoftmaxWith", lambda nn: nn.SoftmaxWithCriterion(), "x", "label"),
    ("SoftmaxWith ignore", lambda nn: nn.SoftmaxWithCriterion(2), "x",
     "label"),
    ("Parallel", lambda nn: nn.ParallelCriterion().add(
        nn.MSECriterion(), 0.5).add(nn.AbsCriterion()), "pair", "pairt"),
    ("TimeDistributed", lambda nn: nn.TimeDistributedCriterion(
        nn.ClassNLLCriterion()), "logp3", "label3"),
    ("Multi", lambda nn: nn.MultiCriterion().add(nn.MSECriterion()).add(
        nn.SmoothL1Criterion(), 2.0), "x", "x"),
    ("MultiLabelSoftMargin", lambda nn: nn.MultiLabelSoftMarginCriterion(),
     "x", "bits"),
    ("SoftMargin", lambda nn: nn.SoftMarginCriterion(), "x", "sign"),
    ("MultiMargin", lambda nn: nn.MultiMarginCriterion(2, margin=0.7), "x",
     "label"),
    ("MAE", lambda nn: nn.MAECriterion(), "x", "x"),
    ("KullbackLeibler", lambda nn: nn.KullbackLeiblerDivergenceCriterion(),
     "prob", "prob"),
    ("Poisson", lambda nn: nn.PoissonCriterion(), "prob", "x"),
    ("CosineProximity", lambda nn: nn.CosineProximityCriterion(), "x", "x"),
    ("MeanAbsolutePercentage",
     lambda nn: nn.MeanAbsolutePercentageCriterion(), "x", "x"),
    ("MeanSquaredLogarithmic",
     lambda nn: nn.MeanSquaredLogarithmicCriterion(), "prob", "prob"),
    ("CosineDistance", lambda nn: nn.CosineDistanceCriterion(), "x", "x"),
    ("DiceCoefficient", lambda nn: nn.DiceCoefficientCriterion(), "prob01",
     "bits"),
    ("KLD", lambda nn: nn.KLDCriterion(), "pair", None),
    ("Gaussian", lambda nn: nn.GaussianCriterion(), "pair", "x"),
    ("L1HingeEmbedding", lambda nn: nn.L1HingeEmbeddingCriterion(2.0),
     "pair", "sign1"),
    ("MultiLabelMargin", lambda nn: nn.MultiLabelMarginCriterion(), "x",
     "multilabel"),
    ("ClassSimplex", lambda nn: nn.ClassSimplexCriterion(5), "x", "label"),
    ("TimeDistributedMask", lambda nn: nn.TimeDistributedMaskCriterion(
        nn.ClassNLLCriterion()), "logp3", "masked"),
]


def _crit_data(kind, rs):
    x = rs.randn(6, 5).astype(np.float32)
    e = np.exp(x)
    return {
        "x": x, "logp": x - np.log(e.sum(1, keepdims=True)),
        "prob": e / e.sum(1, keepdims=True),
        "prob01": 1 / (1 + np.exp(-x)), "label": _labels(rs),
        "label0": _labels(rs) - 1,
        "onehot": np.eye(5, dtype=np.float32)[rs.randint(0, 5, 6)],
        "bits": (rs.rand(6, 5) > 0.5).astype(np.float32),
        "sign": np.sign(rs.randn(6, 5)).astype(np.float32),
        "sign1": np.sign(rs.randn(6)).astype(np.float32),
        "pair": [x, rs.randn(6, 5).astype(np.float32) * 0.5],
        "pairt": [rs.randn(6, 5).astype(np.float32)] * 2,
        "pairv": [x[:, 0], x[:, 1]],
        "logp3": np.log(np.exp(e := rs.randn(6, 3, 5).astype(np.float32))
                        / np.exp(e).sum(-1, keepdims=True)),
        "label3": (rs.randint(0, 5, (6, 3)) + 1).astype(np.float32),
        "masked": [(rs.randint(0, 5, (6, 3)) + 1).astype(np.float32),
                   (rs.rand(6, 3) > 0.3).astype(np.float32)],
        "multilabel": np.array([[3, 1, 0, 2, 0], [5, 0, 0, 0, 0],
                                [2, 4, 5, 0, 1], [1, 2, 3, 4, 5],
                                [0, 0, 0, 0, 0], [4, 4, 0, 0, 0]],
                               np.float32),
        None: None}[kind]


@pytest.mark.parametrize("case", CRITERIA, ids=[c[0] for c in CRITERIA])
def test_criterion_loss_and_grad(case):
    name, build, xk, tk = case
    rs = np.random.RandomState(1)
    x, t = _crit_data(xk, rs), _crit_data(tk, rs)
    jc, tc = build(JNN), build(tnn)
    jx, jt = _jax_in(x), (None if t is None else _jax_in(t))
    want, gx = jax.jit(jax.value_and_grad(
        lambda xi: jc.apply_loss(xi, jt)))(jx)
    tx, tt = _torch_in(x), (None if t is None else _torch_in(t))
    np.testing.assert_allclose(tc.forward(tx, tt), float(want), **TOL)
    _close(tc.backward(tx, tt), gx, f"{name}: grad", dict(rtol=1e-4,
                                                          atol=1e-5))


# -- the checkpoint format ------------------------------------------------------

def _lenet_pair():
    from bigdl_tpu.models import lenet as jlenet
    from bigdl_tpu_torch.models import lenet as tlenet
    return jlenet.build_model(10), tlenet.build_model(10, device="cpu")


def test_weights_cross_load_both_ways(tmp_path):
    jm, tm = _lenet_pair()
    jm.save_weights(str(tmp_path / "j"))
    tm.load_weights(str(tmp_path / "j"))
    _assert_tree(_np(tm.parameters_dict()), _np(jm.parameters_dict()), "j→t")
    tm2 = _lenet_pair()[1]
    tm2.save_weights(str(tmp_path / "t"))
    jm.load_weights(str(tmp_path / "t"))
    _assert_tree(_np(jm.parameters_dict()), _np(tm2.parameters_dict()), "t→j")
    assert tckpt.verify_checkpoint(str(tmp_path / "t"))
    bad = tnn.Sequential().add(tnn.Linear(2, 2))
    with pytest.raises(ValueError, match="do not match"):
        bad.load_weights(str(tmp_path / "t"))


def test_trees_round_trip_dtypes_both_ways(tmp_path):
    tree = {"f32": torch.randn(3, 2), "bf16": torch.randn(4).bfloat16(),
            "i32": torch.tensor(7, dtype=torch.int32),
            "u8": torch.arange(5, dtype=torch.uint8), "empty": torch.zeros(0),
            "py": {"n": 3, "x": 0.5, "s": "a", "none": None},
            "seq": [torch.ones(2), (torch.zeros(1), 2)]}
    tckpt.save_checkpoint(str(tmp_path / "c"), tree, metadata={"k": 1})
    back, meta = tckpt.load_checkpoint(str(tmp_path / "c"))
    assert meta == {"k": 1} and back["py"] == tree["py"]
    for k in ("f32", "bf16", "i32", "u8", "empty"):
        assert back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k])
    assert isinstance(back["seq"][1], tuple)
    jtree, _ = jckpt.load_checkpoint(str(tmp_path / "c"), to_jax=False)
    np.testing.assert_array_equal(jtree["f32"], tree["f32"].numpy())
    np.testing.assert_array_equal(jtree["bf16"].astype(np.float32),
                                  tree["bf16"].float().numpy())
    assert jtree["i32"].dtype == np.int32 and int(jtree["i32"]) == 7
    jckpt.save_checkpoint(str(tmp_path / "j"), jax.tree_util.tree_map(
        lambda a: a.numpy() if a.dtype != torch.bfloat16 else
        jnp.asarray(a.float().numpy(), jnp.bfloat16),
        {k: tree[k] for k in ("f32", "bf16", "i32", "u8")}))
    back, _ = tckpt.load_checkpoint(str(tmp_path / "j"))
    for k in ("f32", "bf16", "i32", "u8"):     # the JAX writer stores a
        assert back[k].dtype == tree[k].dtype  # 0-d array as shape (1,)
        assert torch.equal(back[k].reshape(tree[k].shape), tree[k])


def test_save_module_load_module(tmp_path):
    _, tm = _lenet_pair()
    p = str(tmp_path / "m")
    tm.save_module(p)
    back = TModule.load_module(p, device="cpu")
    assert type(back).__name__ == "Sequential"
    _assert_tree(_np(back.parameters_dict()), _np(tm.parameters_dict()), "m")
    x = torch.randn(2, 28, 28)
    torch.testing.assert_close(back.eval()(x), tm.eval()(x))
    assert tm[1].weight.numel() == 150      # the live weights are back
    with pytest.raises(IOError):
        tm.save_module(p, overwrite=False)
    tree, meta = jckpt.load_checkpoint(p, to_jax=False)   # JAX reads it
    assert meta["class"] == "Sequential" and set(tree) == {"params",
                                                           "states"}


def test_latest_skips_corrupt_and_prune(tmp_path):
    from bigdl_tpu_torch import reliability
    root = str(tmp_path)
    for tag in ("1.5", "2.10", "2.9"):
        for p in ("model.", "optim."):
            tckpt.save_checkpoint(f"{root}/{p}{tag}", {"a": torch.ones(3)})
    assert tckpt.list_checkpoint_tags(root) == ["1.5", "2.9", "2.10"]
    tckpt._corrupt_file(f"{root}/optim.2.10/arrays.safetensors")
    with pytest.raises(tckpt.CheckpointCorruptError):
        tckpt.load_checkpoint(f"{root}/optim.2.10")
    was = reliability.enabled()
    reliability.enable()
    try:
        assert tckpt.latest(root, paired_prefix="model.") == "2.9"
    finally:
        if not was:
            reliability.disable()
    assert tckpt.list_checkpoint_tags(root) == ["1.5", "2.9"]
    assert tckpt.prune_checkpoints(root, 1) == ["1.5", "2.9"]
    assert tckpt.list_checkpoint_tags(root, "model.") == ["2.10"]


def test_injected_corruption_and_commit_fault(tmp_path):
    from bigdl_tpu_torch import reliability
    was = reliability.enabled()
    reliability.enable()
    try:
        reliability.set_plan(reliability.FaultPlan(seed=0).add(
            "checkpoint.write.arrays", "corrupt", times=1))
        tckpt.save_checkpoint(str(tmp_path / "c"), {"a": torch.ones(64)})
        assert not tckpt.verify_checkpoint(str(tmp_path / "c"))
        reliability.set_plan(reliability.FaultPlan(seed=0).add(
            "checkpoint.commit", "raise", times=1))
        with pytest.raises(reliability.InjectedFault):
            tckpt.save_checkpoint(str(tmp_path / "d"), {"a": torch.ones(2)})
        assert not (tmp_path / "d").exists()
        assert not [p for p in tmp_path.iterdir() if ".tmp-" in p.name]
    finally:
        reliability.set_plan(None)
        if not was:
            reliability.disable()

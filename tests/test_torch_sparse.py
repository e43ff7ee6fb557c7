"""The port's ``tensor`` package — ``SparseTensor`` and the ``Tensor``
facade — and the sparse layers held to the JAX package on the CPU, on
the same seeded numpy inputs and the same weights.

``SparseTensor`` method by method: indices, values and shape equal
(values to 1e-6 where a sum's order may differ). The sparse layers:
forward and the parameters' vjp at rtol 1e-5 / atol 1e-6. The ``Tensor``
facade method by method at 1e-6, and its non-aliasing: a narrowed,
selected, cloned or wrapped tensor and its source never write into each
other, as JAX arrays cannot. ``randn`` / ``rand`` are held by contract
(shape, dtype, the same values for a seed): JAX's random bits are not
reproduced.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.tensor import SparseTensor as JSparse
from bigdl_tpu.tensor import Tensor as JTensor

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.tensor import SparseTensor as TSparse
from bigdl_tpu_torch.tensor import Tensor as TTensor
from bigdl_tpu_torch.utils.table import Table


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _coo(rs, shape=(5, 7), nnz=12, dup=True):
    """COO triple with duplicate entries (the coalesce case)."""
    idx = np.stack([rs.randint(0, n, nnz) for n in shape], 1)
    if dup:
        idx[-2:] = idx[:2]
    return idx.astype(np.int32), rs.randn(nnz).astype(np.float32), shape


def _both(idx, vals, shape):
    return JSparse(idx, vals, shape), TSparse(idx, vals, shape,
                                               device="cpu")


def _sparse_case(name, rs):
    """(jax result, port result)."""
    j, t = _both(*_coo(rs))
    j2, t2 = _both(*_coo(rs))
    d = rs.randn(5, 7).astype(np.float32)
    if name == "from_dense":
        d[d < 0.4] = 0
        return JSparse.from_dense(d), TSparse.from_dense(d, device="cpu")
    if name == "from_dense 3-D":
        d3 = rs.randn(2, 3, 4).astype(np.float32) * (rs.rand(2, 3, 4) > .6)
        return JSparse.from_dense(d3), TSparse.from_dense(
            torch.from_numpy(d3))
    if name == "to_dense":
        return j.to_dense(), t.to_dense()
    if name == "matmul_dense":
        w = rs.randn(7, 3).astype(np.float32)
        return j.matmul_dense(jnp.asarray(w)), t.matmul_dense(
            torch.from_numpy(w))
    if name == "coalesce":
        return j.coalesce(), t.coalesce()
    if name == "add":
        return j.add(j2), t.add(t2)
    if name == "mul_scalar":
        return j.mul_scalar(2.5), t.mul_scalar(2.5)
    if name == "mul_dense":
        return j.mul_dense(d), t.mul_dense(d)
    if name == "transpose":
        return j.transpose(), t.transpose()
    if name == "narrow":
        return j.narrow(1, 2, 4), t.narrow(1, 2, 4)
    if name == "concat":
        j3, t3 = _both(*_coo(rs, (5, 3), 4))
        return JSparse.concat([j, j3], 1), TSparse.concat([t, t3], 1)
    if name == "sum":
        return j.sum(), t.sum()
    if name == "apply":
        return j.apply(jnp.tanh), t.apply(torch.tanh)
    if name == "bcoo / torch round trip":
        return (JSparse.from_bcoo(j.to_bcoo()),
                TSparse.from_torch(t.to_torch()))
    if name == "views":
        return ((j.nnz, j.ndim, str(j.dtype), j.shape),
                (t.nnz, t.ndim, str(t.dtype).replace("torch.", ""),
                 t.shape))
    raise KeyError(name)


def _assert_same(got, want, what, rtol=1e-6, atol=1e-6):
    if isinstance(want, JSparse):
        assert isinstance(got, TSparse), what
        assert got.shape == want.shape, what
        assert got.indices.dtype == torch.int32, what
        np.testing.assert_array_equal(_np(got.indices),
                                      np.asarray(want.indices), err_msg=what)
        np.testing.assert_allclose(_np(got.values), np.asarray(want.values),
                                   rtol=rtol, atol=atol, err_msg=what)
    elif isinstance(want, tuple):
        assert got == want, what
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=rtol,
                                   atol=atol, err_msg=what)


@pytest.mark.parametrize("name", [
    "from_dense", "from_dense 3-D", "to_dense", "matmul_dense", "coalesce",
    "add", "mul_scalar", "mul_dense", "transpose", "narrow", "concat",
    "sum", "apply", "bcoo / torch round trip", "views"])
def test_sparse_tensor_equals_jax(name):
    want, got = _sparse_case(name, np.random.RandomState(len(name)))
    _assert_same(got, want, name)


def test_sparse_tensor_validation_and_canonical_dtypes():
    for args in ((np.zeros((3, 3), np.int64), np.zeros(3), (2, 2)),
                 (np.zeros((3, 2), np.int64), np.zeros(2), (2, 2))):
        for cls, kw in ((JSparse, {}), (TSparse, {"device": "cpu"})):
            with pytest.raises(ValueError):
                cls(*args, **kw)
    t = TSparse(np.zeros((1, 2), np.int64), np.ones(1, np.float64), (2, 2),
                device="cpu")
    j = JSparse(np.zeros((1, 2), np.int64), np.ones(1, np.float64), (2, 2))
    assert (t.indices.dtype, t.values.dtype) == (torch.int32, torch.float32)
    assert str(j.values.dtype) == "float32"
    with pytest.raises(TypeError):
        t.add(t.to_dense())


def test_dense_to_sparse_layer_is_the_jax_triple():
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    x[x < 0.3] = 0.0
    got = tnn.DenseToSparse()(torch.from_numpy(x))
    _assert_same(got, jnn.DenseToSparse().forward(jnp.asarray(x)),
                 "DenseToSparse", 0, 0)


def _lookup_ids(rs):
    ids = rs.randint(1, 20, (6, 5)).astype(np.float32)
    ids[rs.rand(6, 5) < 0.3] = 0               # padding
    ids[0] = 0                                 # a bag of padding only
    ids[1, 0] = 25                             # past the table: clipped
    return ids


@pytest.mark.parametrize("layer", [
    "SparseLinear", "SparseLinear no bias", "LookupTableSparse sum",
    "LookupTableSparse mean", "LookupTableSparse sqrtn"])
def test_sparse_layer_forward_and_vjp(layer):
    rs = np.random.RandomState(3)
    if layer.startswith("SparseLinear"):
        def build(nn):
            return nn.SparseLinear(7, 4, with_bias="no" not in layer)
        idx, vals, shape = _coo(rs, (5, 7), 14)
        jx, tx = _both(idx, vals, shape)
    else:
        def build(nn):
            return nn.LookupTableSparse(20, 3, layer.split()[1])
        jx = tx = _lookup_ids(rs)
    jm, tm = build(jnn), build(tnn)
    tm.load_parameters_dict(jax.tree_util.tree_map(
        np.asarray, jm.parameters_dict()))
    jp = jm.parameters_dict()
    jy, vjp = jax.vjp(lambda p: jm.apply(p, {}, jx, training=True)[0], jp)
    g = rs.randn(*jy.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(g))
    ty = tm(tx)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-6)
    for k in jp:
        np.testing.assert_allclose(_np(tm._parameters[k].grad),
                                   np.asarray(jg[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=f"{layer}: d{k}")


def test_sparse_join_table_equals_jax():
    rs = np.random.RandomState(4)
    parts = [_coo(rs, (3, n), 4, dup=False) for n in (2, 5, 1)]
    want = jnn.SparseJoinTable(2).forward([JSparse(*p) for p in parts])
    got = tnn.SparseJoinTable(2)(Table(*[TSparse(*p, device="cpu")
                                         for p in parts]))
    _assert_same(got, want, "SparseJoinTable", 0, 0)
    with pytest.raises(TypeError):
        tnn.SparseJoinTable()([torch.zeros(2, 2)])


# -- the Tensor facade --------------------------------------------------------

A = np.random.RandomState(5).randn(3, 4).astype(np.float32)
B = np.random.RandomState(6).randn(3, 4).astype(np.float32)
M = np.random.RandomState(7).randn(4, 2).astype(np.float32)
V = np.random.RandomState(8).randn(4).astype(np.float32)

# (id, fn(Tensor class, make(array), creation kwargs)) — the same calls
# in both packages
FACADE = [
    ("size shape dim n_element", lambda T, mk, kw: (
        mk(A).size(), mk(A).size(2), mk(A).shape, mk(A).dim(),
        mk(A).n_element(), mk(A).nElement())),
    ("fill zero", lambda T, mk, kw: [mk(A).fill(2.5), mk(A).zero()]),
    ("copy set", lambda T, mk, kw: [mk(A).copy(mk(B)), mk(A).set(mk(B)),
                                    mk(A).set()]),
    ("resize", lambda T, mk, kw: [mk(A).resize(2, 3), mk(A).resize(4, 4),
                                  mk(A).resize_as(mk(M))]),
    ("add sub", lambda T, mk, kw: [mk(A).add(1.5), mk(A).add(mk(B)),
                                   mk(A).add(2.0, mk(B)), mk(A).sub(mk(B)),
                                   mk(A).sub(0.5, mk(B))]),
    ("mul div pow", lambda T, mk, kw: [mk(A).mul(3.0), mk(A).cmul(mk(B)),
                                       mk(A).cdiv(mk(B)), mk(A).div(4.0),
                                       mk(A).pow(2)]),
    ("unary", lambda T, mk, kw: [mk(A).abs().sqrt(), mk(A).exp(),
                                 mk(A).abs().log(), mk(A).clamp(-.5, .5),
                                 mk(A).apply_(lambda x: x * 2 + 1)]),
    ("addcmul addcdiv addr", lambda T, mk, kw: [
        mk(A).addcmul(0.5, mk(A), mk(B)), mk(A).addcdiv(0.5, mk(A), mk(B)),
        mk(np.zeros((4, 4), np.float32)).addr(2.0, mk(V), mk(V))]),
    ("addmm addmv", lambda T, mk, kw: [
        mk(A[:, :2]).addmm(mk(A), mk(M)), mk(A[:, :2]).addmm(0.5, mk(A),
                                                             mk(M)),
        mk(A[:, :2]).addmm(0.5, 2.0, mk(A), mk(M)),
        mk(A[:, 0]).addmv(mk(A), mk(V)), mk(A[:, 0]).addmv(2.0, 3.0, mk(A),
                                                           mk(V))]),
    ("shape ops", lambda T, mk, kw: [
        mk(A).clone(), mk(A).contiguous(), mk(A).view(4, 3),
        mk(A).view((2, 6)), mk(A).reshape(12), mk(A).t(),
        mk(A).transpose(1, 2), mk(A).narrow(2, 2, 2), mk(A).select(1, 3),
        mk(A[None]).squeeze(), mk(A[None]).squeeze(1), mk(A).squeeze(1),
        mk(A).unsqueeze(2), mk(A).index_select(2, mk(np.array(
            [4.0, 1.0, 2.0], np.float32))), mk(A).astype(np.int32)]),
    ("products", lambda T, mk, kw: [mk(A).mm(mk(M)), mk(A).mv(mk(V)),
                                    mk(A) @ mk(M), mk(V).dot(mk(V))]),
    ("reductions", lambda T, mk, kw: [
        mk(A).sum(), mk(A).sum(2), mk(A).mean(), mk(A).mean(1),
        mk(A).max(), *mk(A).max(2), mk(A).min(), *mk(A).min(1),
        mk(A).norm(), mk(A).norm(1), mk(A).almost_equal(mk(A + 1e-7)),
        mk(A).almost_equal(mk(B)), float(mk(A).select(1, 1).select(1, 2))]),
    ("operators", lambda T, mk, kw: [
        mk(A) + mk(B), mk(A) + 2.0, 2.0 + mk(A), mk(A) - mk(B),
        1.0 - mk(A), mk(A) * mk(B), 3.0 * mk(A), mk(A) / mk(B), -mk(A),
        mk(A)[1], mk(A)[:, 1:3]]),
    ("setitem", lambda T, mk, kw: [_set(mk(A), (1, 2), 9.0),
                                   _set(mk(A), slice(0, 2), mk(B[:2]))]),
    ("creation", lambda T, mk, kw: [
        T.zeros(2, 3, **kw), T.ones(2, **kw), T.arange(5, **kw),
        T.arange(2, 8, 2, **kw), T(2, 3, **kw), T([1, 2, 3], **kw),
        T(**kw)]),
]


def _set(t, item, value):
    t[item] = value
    return t


def _out(x):
    """A result as numpy / Python values, whichever package made it."""
    if isinstance(x, (JTensor, TTensor)):
        return np.asarray(x.to_numpy())
    if isinstance(x, (list, tuple)):
        return type(x)(_out(v) for v in x)
    return x


@pytest.mark.parametrize("name,fn", FACADE, ids=[c[0] for c in FACADE])
def test_tensor_facade_equals_jax(name, fn):
    want = _out(fn(JTensor, JTensor, {}))
    got = _out(fn(TTensor, lambda a: TTensor(a, device="cpu"),
                  {"device": "cpu"}))
    for w, g in zip(want if isinstance(want, list) else [want],
                    got if isinstance(got, list) else [got]):
        if isinstance(w, tuple):
            assert g == w, name
        else:
            assert np.shape(g) == np.shape(w), (name, np.shape(g))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
            assert np.asarray(g).dtype == np.asarray(w).dtype, name


def test_tensor_facade_never_aliases():
    """Every way to get a second ``Tensor`` of the same values keeps it
    apart from the first, as the JAX facade's immutable arrays do."""
    for T, kw in ((JTensor, {}), (TTensor, {"device": "cpu"})):
        parent = T(A.copy(), **kw)
        views = [parent.narrow(1, 2, 1), parent.select(2, 1),
                 parent.view(12), parent.clone(), T(parent), parent[0],
                 parent.t(), parent.squeeze(1)]
        for v in views:
            v.fill(7.0)
        np.testing.assert_array_equal(parent.to_numpy(), A)
        snap = [v.to_numpy().copy() for v in views]
        parent[0, 0] = -1.0
        parent.add(1.0).mul(2.0)
        for v, s in zip(views, snap):
            np.testing.assert_array_equal(v.to_numpy(), s)
        other = T(B.copy(), **kw)
        parent.copy(other)
        other[1, 1] = 100.0
        np.testing.assert_array_equal(parent.to_numpy(), B)
    src = torch.from_numpy(A.copy())
    wrapped = TTensor(src)
    src.add_(1.0)                          # a caller's in-place write
    np.testing.assert_array_equal(wrapped.to_numpy(), A)
    arr = A.copy()
    wrapped = TTensor(arr, device="cpu")
    arr += 1.0
    np.testing.assert_array_equal(wrapped.to_numpy(), A)


def test_tensor_random_contract():
    for draw in (TTensor.randn, TTensor.rand):
        a = draw(3, 4, seed=3, device="cpu")
        assert a.shape == (3, 4) and a.dtype() == torch.float32
        np.testing.assert_array_equal(
            a.to_numpy(), draw(3, 4, seed=3, device="cpu").to_numpy())
        assert not np.array_equal(
            a.to_numpy(), draw(3, 4, seed=4, device="cpu").to_numpy())
    u = TTensor.rand(1000, seed=0, device="cpu").to_numpy()
    assert 0 <= u.min() and u.max() < 1
    if not torch.cuda.is_available():      # the GPU unless asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTensor(2, 3)

"""The port's LeNet-5 and ResNet held to the JAX package on the CPU, with
the JAX weights carried over: ResNet-50's forward at 1x3x64x64 (as the
JAX package's own shape test), one ``LocalOptimizer`` step of
``resnet_cifar(8)`` under SGD with momentum and weight decay (loss,
every parameter and the BN running statistics within 1e-4), NHWC equal
to NCHW, and ``remat=True`` equal to the plain model."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
import bigdl_tpu.optim as joptim
from bigdl_tpu.models import lenet as jlenet, resnet as jresnet

import bigdl_tpu_torch.nn as tnn
import bigdl_tpu_torch.optim as toptim
from bigdl_tpu_torch.models import lenet as tlenet, resnet as tresnet
from bigdl_tpu_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


def _carry(jm, tm):
    tm.load_parameters_dict(jax.tree_util.tree_map(np.asarray,
                                                   jm.parameters_dict()))
    tm.load_states_dict(jax.tree_util.tree_map(np.asarray,
                                               jm.states_dict()))
    return tm


def _assert_leaves(got, want, **tol):
    g = [p.detach().numpy() for p in tree_leaves(got)]
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def test_resnet50_forward_matches_jax():
    jm = jresnet.resnet_imagenet(50, 1000)
    tm = _carry(jm, tresnet.resnet_imagenet(50, 1000, device="cpu"))
    assert tm.n_parameters() == 25_557_032 == sum(
        int(np.prod(a.shape)) for a in
        jax.tree_util.tree_leaves(jm.parameters_dict()))
    x = np.random.RandomState(0).rand(1, 3, 64, 64).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, training=False))(
        jm.parameters_dict(), jm.states_dict(), jnp.asarray(x))
    got = tm.eval()(torch.from_numpy(x))
    assert got.shape == (1, 1000)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _cifar_step(o, nn, m, x, y, **kw):
    opt = o.LocalOptimizer(m, (x, y), nn.ClassNLLCriterion(), 4,
                           o.Trigger.max_iteration(2), **kw)
    opt.set_optim_method(o.SGD(0.1, momentum=0.9, weight_decay=1e-4))
    trained = opt.optimize()
    return trained, opt.state["loss"]


def test_resnet_cifar8_training_step_matches_jax():
    """Two SGD iterations (the second reads the first's momentum) of the
    depth-8 CIFAR ResNet in f32, batch 4, 1-based labels."""
    rs = np.random.RandomState(0)
    x = rs.rand(8, 3, 32, 32).astype(np.float32)
    y = (rs.randint(0, 10, 8) + 1).astype(np.float32)
    jm = jresnet.resnet_cifar(8, 10)
    tm = _carry(jm, tresnet.resnet_cifar(8, 10, device="cpu"))
    jt, jloss = _cifar_step(joptim, jnn, jm, x, y)
    tt, tloss = _cifar_step(toptim, tnn, tm, x, y, device="cpu")
    assert tloss == pytest.approx(jloss, rel=1e-5)
    _assert_leaves(tt.parameters_dict(), jt.parameters_dict(), rtol=1e-4,
                   atol=1e-4)
    _assert_leaves(tt.states_dict(), jt.states_dict(), rtol=1e-4,
                   atol=1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_nhwc_and_remat_equal_plain(remat):
    """ResNet-18 (basic blocks) in NHWC, and wrapped in ``nn.Checkpoint``
    blocks, on the NCHW model's weights: one training step gives the
    same loss, grads (within 2e-3 of each tensor's largest) and running
    statistics. The weights come from a seeded init stream, not from
    whatever the tests before left in it: on 2 of 64 seeds a batch-norm
    output within 2e-6 of zero takes the other side of a ReLU in one
    layout (the convolutions sum in other orders), which moves a whole
    gradient term."""
    tnn.set_seed(0)
    torch.manual_seed(0)
    ref = tresnet.resnet_imagenet(18, 10, device="cpu")
    other = tresnet.resnet_imagenet(18, 10, format="NHWC" if not remat
                                    else "NCHW", remat=remat, device="cpu")
    # a Checkpoint block holds the block under its key "0"
    other.load_parameters_dict({
        k: {"0": v} if isinstance(other[int(k)], tnn.Checkpoint) else v
        for k, v in ref.parameters_dict().items()})
    x = torch.rand(2, 3, 40, 40)
    t = torch.tensor([3.0, 7.0])
    crit = tnn.ClassNLLCriterion()
    losses, grads = [], []
    for m, xi in ((ref, x), (other, x if remat else
                             x.permute(0, 2, 3, 1).contiguous())):
        loss = crit.apply_loss(m.train()(xi), t)
        g = torch.autograd.grad(loss, tree_leaves(m.parameters_dict()))
        losses.append(loss.item())
        grads.append(g)
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    for a, b in zip(*grads):       # conv algorithms sum in other orders
        torch.testing.assert_close(a, b, rtol=1e-3,
                                   atol=2e-3 * float(a.abs().max()))
    for a, b in zip(tree_leaves(ref.states_dict()),
                    tree_leaves(other.states_dict())):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_model_constructors():
    assert isinstance(tresnet.build_model(20, 10, "cifar10", device="cpu"),
                      tnn.Sequential)
    with pytest.raises(ValueError):
        tresnet.resnet_cifar(9, device="cpu")
    jm = jlenet.build_model(10)
    tm = _carry(jm, tlenet.build_model(10, device="cpu"))
    assert [n.name for n in tm.modules()][2] == "conv1_5x5"
    x = np.random.RandomState(1).rand(3, 28, 28).astype(np.float32)
    np.testing.assert_allclose(tm.eval()(torch.from_numpy(x)).detach(),
                               np.asarray(jm.evaluate().forward(x)),
                               rtol=1e-5, atol=1e-5)

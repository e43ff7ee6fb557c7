"""The port's Inception-v1, VGG, RNN language model and autoencoder, and
its feature pipeline (the sample transformers, the vision pipeline, the
ImageNet folder reader and the CIFAR reader), held to the JAX package on
the CPU. The models carry the JAX weights and compare the output and
the input and parameter gradients of a ``ClassNLLCriterion`` (an MSE
for the autoencoder) loss at rtol 1e-4 / atol 1e-4, in eval mode
(dropout off, batch norm on its running statistics) except the RNN,
which has neither. The pipeline is host numpy with seeded ``numpy``
streams: its outputs equal the JAX package's bit for bit. The folder
and CIFAR readers read files the tests write (JPEGs through PIL)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.nn as jnn
from bigdl_tpu.feature import cifar as jcifar, imagenet as jimagenet
from bigdl_tpu.feature import transformers as jtr
from bigdl_tpu.feature import vision as jvision
from bigdl_tpu.feature.dataset import Sample as JSample
from bigdl_tpu.models import (autoencoder as jauto, inception as jinc,
                              rnn as jrnn, vgg as jvgg)

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.feature import cifar as tcifar, imagenet as timagenet
from bigdl_tpu_torch.feature import transformers as ttr
from bigdl_tpu_torch.feature import vision as tvision
from bigdl_tpu_torch.feature.dataset import Sample as TSample
from bigdl_tpu_torch.models import (autoencoder as tauto, inception as tinc,
                                    rnn as trnn, vgg as tvgg)
from bigdl_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-4)


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


def _loss_and_grads(jm, tm, x, y, crit, training):
    """The JAX loss and its gradients (jit) beside the port's (autograd)."""
    jc, tc = getattr(jnn, crit)(), getattr(tnn, crit)()
    js = jm.states_dict()

    def loss(p, xi):
        return jc.apply_loss(jm.apply(p, js, xi, training=training)[0],
                             jnp.asarray(y))

    jl, (gp, gx) = jax.jit(jax.value_and_grad(loss, (0, 1)))(
        jm.parameters_dict(), jnp.asarray(x))
    tm.train(training)
    xt = torch.from_numpy(x).requires_grad_(x.dtype == np.float32)
    tl = tc.apply_loss(tm(xt), torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    if xt.requires_grad:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    got = [p.grad.numpy() for p in tree_leaves(tm.parameters_dict())]
    want = jax.tree_util.tree_leaves(gp)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_inception_v1_full_width_forward_and_grads():
    """``inception_v1(1000)`` at 64 x 64, batch 2: the parameter count,
    the log-probabilities, the loss and every gradient."""
    jm = jinc.inception_v1(1000)
    tm = _carry(jm, tinc.inception_v1(1000, device="cpu"))
    assert tm.n_parameters() == 6_998_552 == sum(
        int(np.prod(a.shape))
        for a in jax.tree_util.tree_leaves(jm.parameters_dict()))
    rs = np.random.RandomState(0)
    x = rs.rand(2, 3, 64, 64).astype(np.float32)
    y = np.array([3.0, 907.0], np.float32)
    want, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, training=False))(
        jm.parameters_dict(), jm.states_dict(), jnp.asarray(x))
    got = tm.eval()(torch.from_numpy(x))
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    _loss_and_grads(jm, tm, x, y, "ClassNLLCriterion", False)


def test_vgg_cifar_and_vgg16():
    rs = np.random.RandomState(1)
    jm = jvgg.vgg_cifar(10)
    tm = _carry(jm, tvgg.vgg_cifar(10, device="cpu"))
    x = rs.rand(2, 3, 32, 32).astype(np.float32)
    _loss_and_grads(jm, tm, x, np.array([1.0, 10.0], np.float32),
                    "ClassNLLCriterion", False)
    jm = jvgg.vgg16(1000)
    tm = _carry(jm, tvgg.vgg16(1000, device="cpu"))
    assert tm.n_parameters() == 138_357_544
    x = rs.rand(1, 3, 224, 224).astype(np.float32)
    want, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, training=False))(
        jm.parameters_dict(), jm.states_dict(), jnp.asarray(x))
    got = tm.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_rnn_language_model(cell):
    """Two recurrent layers of each cell over 1-based token ids, the
    loss ``TimeDistributedCriterion(ClassNLLCriterion())``."""
    jm = jrnn.build_model(20, 8, 20, cell, 2)
    tm = _carry(jm, trnn.build_model(20, 8, 20, cell, 2, device="cpu"))
    rs = np.random.RandomState(2)
    ids = (rs.randint(0, 20, (3, 7)) + 1).astype(np.float32)
    tgt = (rs.randint(0, 20, (3, 7)) + 1).astype(np.float32)
    jc = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())
    tc = tnn.TimeDistributedCriterion(tnn.ClassNLLCriterion())
    jl, gp = jax.jit(jax.value_and_grad(lambda p: jc.apply_loss(
        jm.apply(p, {}, jnp.asarray(ids), training=True)[0],
        jnp.asarray(tgt))))(jm.parameters_dict())
    tl = tc.apply_loss(tm.train()(torch.from_numpy(ids)),
                       torch.from_numpy(tgt))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for a, b in zip(tree_leaves(tm.parameters_dict()),
                    jax.tree_util.tree_leaves(gp)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **TOL)
    with pytest.raises(ValueError, match="unknown cell"):
        trnn.build_model(cell="lstm2", device="cpu")


def test_autoencoder():
    jm = jauto.build_model(32)
    tm = _carry(jm, tauto.build_model(32, device="cpu"))
    rs = np.random.RandomState(3)
    x = rs.rand(4, 28, 28).astype(np.float32)
    _loss_and_grads(jm, tm, x, x.reshape(4, 784), "MSECriterion", True)


def test_model_builders_need_a_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tinc.inception_v1(), lambda: tvgg.vgg_cifar(),
                  lambda: tvgg.vgg16(), lambda: trnn.build_model(),
                  lambda: tauto.build_model()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


# -- the feature pipeline ---------------------------------------------------------

def _samples(S, n=6, shape=(3, 6, 5)):
    rs = np.random.RandomState(4)
    return [S(rs.rand(*shape).astype(np.float32),
              np.float32(rs.randint(1, 5))) for _ in range(n)]


def _same_samples(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g.features) == len(w.features)
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


TRANSFORMERS = [
    ("Normalizer", lambda m: m.Normalizer(0.4, 0.2)),
    ("OneHot", lambda m: m.OneHot(5)),
    ("OneHot zero-based", lambda m: m.OneHot(6, zero_based=True)),
    ("HFlip", lambda m: m.HFlip(0.5, seed=3)),
    ("RandomCrop", lambda m: m.RandomCrop(4, 3, seed=1)),
    ("RandomCrop padded", lambda m: m.RandomCrop(5, 5, padding=2, seed=2)),
    ("MapTransformer", lambda m: m.MapTransformer(
        lambda s: type(s)([s.features[0] * 2], s.labels))),
    ("chain", lambda m: m.HFlip(seed=1) >> m.RandomCrop(4, 4, 1, seed=5)
     >> m.Normalizer(0.5, 0.25)),
]


@pytest.mark.parametrize("case", TRANSFORMERS, ids=[c[0] for c in TRANSFORMERS])
def test_sample_transformers_bit_equal(case):
    _, build = case
    _same_samples(build(ttr)(iter(_samples(TSample))),
                  build(jtr)(iter(_samples(JSample))))


def _png_bytes(img):
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


VISION = [
    ("decode Resize", lambda v: v.PixelBytesToMat() >> v.Resize(7, 9)),
    ("AspectScale CenterCrop", lambda v: v.PixelBytesToMat()
     >> v.AspectScale(8, 20) >> v.CenterCrop(6, 5)),
    ("RandomCrop RandomHFlip HFlip", lambda v: v.PixelBytesToMat()
     >> v.RandomCrop(7, 6, seed=1) >> v.RandomHFlip(0.5, seed=2)
     >> v.HFlip()),
    ("Brightness Contrast Saturation", lambda v: v.PixelBytesToMat()
     >> v.Brightness(-20, 20, seed=3) >> v.Contrast(0.6, 1.4, seed=4)
     >> v.Saturation(0.5, 1.5, seed=5)),
    ("Hue", lambda v: v.PixelBytesToMat() >> v.Hue(seed=6)),
    ("ColorJitter RandomTransformer", lambda v: v.PixelBytesToMat()
     >> v.ColorJitter(seed=7) >> v.RandomTransformer(v.HFlip(), 0.5, 8)),
    ("normalize to sample", lambda v: v.PixelBytesToMat()
     >> v.ChannelScaledNormalizer() >> v.ChannelNormalize(
         0.4, 0.5, 0.6, 0.2, 0.25, 0.3) >> v.MatToTensor(to_rgb=True)
     >> v.ImageFrameToSample()),
]


@pytest.mark.parametrize("case", VISION, ids=[c[0] for c in VISION])
def test_vision_pipeline_bit_equal(case, tmp_path):
    _, build = case
    rs = np.random.RandomState(9)
    imgs = [rs.randint(0, 256, (10 + i, 12, 3)).astype(np.uint8)
            for i in range(4)]
    for i, img in enumerate(imgs):
        (tmp_path / f"{i}.png").write_bytes(_png_bytes(img))
    out = []
    for v in (jvision, tvision):
        frame = v.ImageFrame.read(str(tmp_path / "*.png"))
        assert frame.is_local() and not frame.is_distributed()
        out.append(frame.transform(build(v)))
    jf, tf = out
    assert len(jf) == len(tf) == 4
    for j, t in zip(jf.features, tf.features):
        assert set(j) == set(t) and "isValid" not in t
        for k in j:
            if k == "sample":
                _same_samples([t[k]], [j[k]])
            else:
                np.testing.assert_array_equal(np.asarray(t[k]),
                                              np.asarray(j[k]))


def test_image_frame_from_arrays_and_invalid_images():
    rs = np.random.RandomState(10)
    imgs = [rs.randint(0, 256, (6, 5, 3)).astype(np.uint8) for _ in range(3)]
    frames = [v.ImageFrame.from_arrays(imgs, [1, 2, 3]) >> (
        v.ChannelScaledNormalizer() >> v.MatToTensor()
        >> v.ImageFrameToSample()) for v in (jvision, tvision)]
    _same_samples(frames[1].to_samples(), frames[0].to_samples())
    assert frames[1].get_label() == [1, 2, 3]
    bad = tvision.ImageFrame.from_arrays([np.zeros((2, 2), np.uint8)])
    f = tvision.PixelBytesToMat()(bad.features[0])      # no bytes: a failure
    assert f["isValid"] is False and "bytes" in f["error"]


def _write_jpegs(root, classes=3, per=2, size=(40, 52)):
    from PIL import Image
    rs = np.random.RandomState(11)
    for c in range(classes):
        os.makedirs(os.path.join(root, f"n{c:08d}"))
        for i in range(per):
            img = rs.randint(0, 256, size + (3,)).astype(np.uint8)
            Image.fromarray(img).save(
                os.path.join(root, f"n{c:08d}", f"{i}.JPEG"), quality=90)


@pytest.mark.parametrize("train", [True, False])
def test_image_folder_dataset_bit_equal(train, tmp_path):
    _write_jpegs(str(tmp_path))
    dss = [m.ImageFolderDataSet(str(tmp_path), image_size=32, train=train,
                                seed=3) for m in (jimagenet, timagenet)]
    assert dss[1].size() == 6 and dss[1].class_names == dss[0].class_names
    for _ in range(2):                          # two epochs: the shuffle
        _same_samples(dss[1].data(train=True), dss[0].data(train=True))


def test_synthetic_imagenet_and_the_transform_chain():
    ds = [m.synthetic_imagenet_dataset(n=6, classes=10, image_size=20,
                                       seed=4) for m in (jimagenet, timagenet)]
    chain = [tr.RandomCrop(16, 16, seed=1) >> tr.HFlip(seed=2)
             for tr in (jtr, ttr)]
    _same_samples(ds[1].transform(chain[1]).data(train=True),
                  ds[0].transform(chain[0]).data(train=True))
    assert ds[1].size() == 6


def test_cifar_readers_bit_equal(tmp_path):
    rs = np.random.RandomState(12)
    for name, lb in (("data_batch_1.bin", 1), ("data_batch_2.bin", 1),
                     ("data_batch_3.bin", 1), ("data_batch_4.bin", 1),
                     ("data_batch_5.bin", 1), ("test_batch.bin", 1)):
        rec = np.concatenate([rs.randint(0, 10, (4, lb)),
                              rs.randint(0, 256, (4, 3072))], axis=1)
        rec.astype(np.uint8).tofile(str(tmp_path / name))
    rec = np.concatenate([rs.randint(0, 20, (5, 1)), rs.randint(0, 100, (5, 1)),
                          rs.randint(0, 256, (5, 3072))], axis=1)
    rec.astype(np.uint8).tofile(str(tmp_path / "train.bin"))
    for kw in (dict(folder=str(tmp_path)),
               dict(folder=str(tmp_path), train=False),
               dict(folder=str(tmp_path), classes=100),
               dict(synthetic_size=16, seed=3),
               dict(synthetic_size=16, classes=100, train=False)):
        for a, b in zip(tcifar.load_cifar(**kw), jcifar.load_cifar(**kw)):
            np.testing.assert_array_equal(a, b)
    x, y = tcifar.load_cifar(folder=str(tmp_path))
    assert x.shape == (20, 3, 32, 32) and y.min() >= 1
    assert tcifar.nearest_prototype_accuracy(x, y) == \
        jcifar.nearest_prototype_accuracy(x, y)
    for aug in (True, False):
        _same_samples(
            tcifar.cifar_dataset(synthetic_size=8, seed=1,
                                 augment=aug).data(train=True),
            jcifar.cifar_dataset(synthetic_size=8, seed=1,
                                 augment=aug).data(train=True))
    with open(str(tmp_path / "bad.bin"), "wb") as f:
        f.write(b"\0" * 3000)
    with pytest.raises(ValueError, match="not a multiple"):
        tcifar._read_bin(str(tmp_path / "bad.bin"), 1)

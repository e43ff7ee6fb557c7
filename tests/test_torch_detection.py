"""The port's detection ops (``bigdl_tpu_torch.nn.layers.detection``) and
Mask R-CNN (``bigdl_tpu_torch.models.maskrcnn``) held to the JAX package
on the CPU, on the same seeded numpy inputs and the same weights.

Tolerances: ROIAlign, IoU and the box codecs 1e-5 relative / 1e-5
absolute (f32 sums in another order); NMS indices and validity exactly,
with tied scores and all −inf rows. Mask R-CNN: labels and valid slots
exactly (tied RPN scores too, on a blank image); boxes within 1e-2
pixels, scores 5e-5, masks 1e-3 (the 6.12 M-parameter default drifts to
4.8e-3 pixels on a box through two decodes; the tiny one to 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.models import maskrcnn as jm
from bigdl_tpu.nn.layers import detection as jd

import bigdl_tpu_torch.nn as tnn
from bigdl_tpu_torch.models import maskrcnn as tm
from bigdl_tpu_torch.nn.layers import detection as td
from bigdl_tpu_torch.nn.layers import extra3
from bigdl_tpu_torch.utils.table import Table

TOL = dict(rtol=1e-5, atol=1e-5)


def _boxes(rs, n, size=64.0):
    xy = rs.uniform(-4, size, (n, 2))
    wh = rs.uniform(0.5, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _tied_scores(rs, n):
    s = rs.randint(0, 4, n).astype(np.float32)       # many ties
    s[rs.rand(n) < 0.2] = -np.inf                    # already suppressed
    return s


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _case(name, rs):
    """(jax result, port result) of one op on seeded inputs."""
    if name.startswith("roi_align"):
        p, scale, s = {"roi_align": (7, 0.25, 2),
                       "roi_align_p3_s3": (3, 1.0, 3)}[name]
        f = rs.randn(2, 13, 11, 5).astype(np.float32)
        b = _boxes(rs, 9, 48.0 if scale < 1 else 12.0)
        bi = rs.randint(0, 2, 9).astype(np.int32)
        return (jax.jit(jd.roi_align, static_argnums=(3, 4, 5))(
                    jnp.asarray(f), jnp.asarray(b), jnp.asarray(bi), p,
                    scale, s),
                td.roi_align(torch.from_numpy(f), torch.from_numpy(b),
                             torch.from_numpy(bi), p, scale, s))
    if name == "RoiAlign":
        f = rs.randn(1, 8, 8, 3).astype(np.float32)
        b = _boxes(rs, 4, 8.0)
        return (jd.RoiAlign(3).forward([jnp.asarray(f), jnp.asarray(b),
                                        np.zeros(4, np.int32)]),
                tnn.RoiAlign(3)(Table(torch.from_numpy(f),
                                      torch.from_numpy(b),
                                      torch.zeros(4))))
    if name == "box_iou":
        a, b = _boxes(rs, 7), _boxes(rs, 5)
        a[0, 2:] = a[0, :2]                          # a degenerate box
        return (jd.box_iou(jnp.asarray(a), jnp.asarray(b)),
                td.box_iou(torch.from_numpy(a), torch.from_numpy(b)))
    if name.startswith("nms"):
        n, max_out = (40, 12) if name == "nms" else (6, 9)
        b = _boxes(rs, n, 32.0)
        b[1] = b[0]                                  # identical boxes
        s = _tied_scores(rs, n)
        jk, jv = jd.nms(jnp.asarray(b), jnp.asarray(s), 0.4, max_out)
        tk, tv = td.nms(torch.from_numpy(b), torch.from_numpy(s), 0.4,
                        max_out)
        return (np.stack([jk, jv]), torch.stack([tk, tv.int()]))
    if name == "codecs":
        a, b = _boxes(rs, 11) + 1, _boxes(rs, 11) + 1
        d = rs.randn(11, 4).astype(np.float32) * 3   # beyond the dw clamp
        w = (10.0, 10.0, 5.0, 5.0)
        return ([jd.encode_boxes(jnp.asarray(a), jnp.asarray(b), w),
                 jd.decode_boxes(jnp.asarray(a), jnp.asarray(d), w),
                 jd.clip_boxes(jnp.asarray(b), 30.0, 20.0)],
                [td.encode_boxes(torch.from_numpy(a), torch.from_numpy(b), w),
                 td.decode_boxes(torch.from_numpy(a), torch.from_numpy(d), w),
                 td.clip_boxes(torch.from_numpy(b), 30.0, 20.0)])
    if name == "anchors":
        return (jd.generate_anchors(5, 7, 8, [16.0, 32.0], (0.5, 1.0, 3.0)),
                td.generate_anchors(5, 7, 8, [16.0, 32.0], (0.5, 1.0, 3.0)))
    if name == "levels on boundaries":
        # sqrt(area) at and one ulp around 28, 56, 112: the level edges
        e = np.array([28.0, 56.0, 112.0], np.float32)
        side = np.concatenate([e, np.nextafter(e, 0), np.nextafter(e, 1e9),
                               rs.uniform(1, 224, 40).astype(np.float32)])
        b = np.stack([side * 0 + 3, side * 0 + 5, side + 3, side + 5], 1)
        pyr = [rs.randn(2, 224 // s, 224 // s, 4).astype(np.float32)
               for s in (4, 8, 16, 32)]
        bi = rs.randint(0, 2, len(b)).astype(np.int32)
        cfg_j, cfg_t = jm.MaskRCNNConfig(), tm.MaskRCNNConfig()
        pool = jax.jit(lambda pyr, b, bi: jm._pyramid_roi_align(
            pyr, cfg_j, b, bi, 7))
        # the JAX model runs jitted: its levels are the jitted op's
        return ([jax.jit(jm._assign_levels, static_argnums=1)(
                    jnp.asarray(b), 4),
                 pool([jnp.asarray(p) for p in pyr], jnp.asarray(b),
                      jnp.asarray(bi))],
                [tm._assign_levels(torch.from_numpy(b), 4),
                 tm._pyramid_roi_align([torch.from_numpy(p) for p in pyr],
                                       cfg_t, torch.from_numpy(b),
                                       torch.from_numpy(bi), 7)])
    if name == "top_k ties":
        s = np.array([[1, 3, 3, 2, 3], [0, 0, 0, 0, 0]], np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(s), 3)
        tv, ti = tm._top_k(torch.from_numpy(s), 3)
        return [jv, ji], [tv, ti]
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "roi_align", "roi_align_p3_s3", "RoiAlign", "box_iou", "nms",
    "nms max_out above n", "codecs", "anchors", "levels on boundaries",
    "top_k ties"])
def test_detection_op_equals_jax(name):
    want, got = _case(name, np.random.RandomState(len(name)))
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    for w, g in zip(want, got):
        w, g = np.asarray(w), _np(g)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_nms_batched_is_per_image_and_stays_on_tensors():
    """A batch of images gives each image's own selection; a step with
    nothing left selects index 0 and is not valid."""
    rs = np.random.RandomState(0)
    b = np.stack([_boxes(rs, 10), _boxes(rs, 10)])
    s = np.stack([_tied_scores(rs, 10), np.full(10, -np.inf, np.float32)])
    k, v = td.nms(torch.from_numpy(b), torch.from_numpy(s), 0.5, 6)
    for i in range(2):
        ki, vi = td.nms(torch.from_numpy(b[i]), torch.from_numpy(s[i]), 0.5,
                        6)
        assert torch.equal(k[i], ki) and torch.equal(v[i], vi)
    assert not v[1].any() and not k[1].any()


def test_anchor_layer_uses_the_detection_generator():
    assert extra3.generate_anchors is td.generate_anchors
    got = extra3.Anchor(16, (32.0, 64.0))(torch.zeros(1, 2, 3, 4))
    np.testing.assert_array_equal(
        got.numpy(), jd.generate_anchors(3, 4, 16, (32.0, 64.0)))


def _images(kind, cfg, b):
    rs = np.random.RandomState(7)
    if kind == "blank":                   # every RPN score tied
        return np.zeros((b, cfg.image_size, cfg.image_size, 3), np.float32)
    return rs.rand(b, cfg.image_size, cfg.image_size, 3).astype(np.float32)


@pytest.mark.parametrize("config,batch,kind", [
    ("tiny", 2, "random"), ("tiny", 2, "blank"), ("default", 1, "random")])
def test_maskrcnn_forward_equals_jax(config, batch, kind):
    cfg_j = jm.MaskRCNNConfig.tiny() if config == "tiny" \
        else jm.MaskRCNNConfig()
    cfg_t = tm.MaskRCNNConfig(**vars(cfg_j))
    # one set of weights in both: drawn by the port's initialiser (the
    # JAX one compiles each draw), carried as numpy
    tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                  tm.init_params(cfg_t, 3, device="cpu"))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tm.params_from_jax(tree, "cpu")
    if config == "default":
        assert tm.num_params(tp) == 6_119_669
    x = _images(kind, cfg_j, batch)
    want = jax.jit(lambda p, x: jm.forward(p, cfg_j, x))(jp, jnp.asarray(x))
    with torch.inference_mode():
        got = tm.forward(tp, cfg_t, torch.from_numpy(x))
    assert got["labels"].dtype == torch.int32
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    # a valid slot has a score above the threshold, an invalid one 0
    np.testing.assert_array_equal(got["scores"].numpy() > 0,
                                  np.asarray(want["scores"]) > 0)
    for k, atol in (("boxes", 1e-2), ("scores", 5e-5), ("masks", 1e-3)):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=atol, err_msg=k)


def test_maskrcnn_facade_and_init_contract():
    """The facade returns numpy arrays of fixed shapes; the port's own
    initialiser has the JAX tree's keys and shapes (``eval_shape``: no
    JAX draw runs) and its scales, and is deterministic for a seed."""
    cfg = tm.MaskRCNNConfig.tiny()
    j = jax.eval_shape(lambda: jm.init_params(jm.MaskRCNNConfig.tiny(), 0))
    t = tm.init_params(cfg, 5, device="cpu")
    assert jax.tree_util.tree_structure(j) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda a: 0, t))
    for a, b in zip(jax.tree_util.tree_leaves(j),
                    jax.tree_util.tree_leaves(t)):
        assert tuple(b.shape) == a.shape
        fan_in = int(np.prod(a.shape[1:]))
        scale = np.sqrt((2.0 if len(a.shape) == 4 else 1.0) / fan_in)
        assert b.std().item() == pytest.approx(
            scale if len(a.shape) > 1 else 0.0, rel=0.25)
    m = tm.MaskRCNN(cfg, seed=5, device="cpu")
    out = m(_images("random", cfg, 2))
    again = tm.MaskRCNN(cfg, seed=5, device="cpu")(_images("random", cfg, 2))
    d, s = cfg.detections_per_img, cfg.mask_size
    assert {k: v.shape for k, v in out.items()} == {
        "boxes": (2, d, 4), "scores": (2, d), "labels": (2, d),
        "masks": (2, d, s, s)}
    assert all(isinstance(v, np.ndarray) for v in out.values())
    assert ((out["labels"] >= 0) & (out["labels"] < cfg.num_classes)).all()
    assert ((out["masks"] >= 0) & (out["masks"] <= 1)).all()
    assert ((out["boxes"] >= 0) & (out["boxes"] <= cfg.image_size)).all()
    for k in out:
        np.testing.assert_array_equal(out[k], again[k])
    if not torch.cuda.is_available():      # the GPU unless asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tm.MaskRCNN(cfg)

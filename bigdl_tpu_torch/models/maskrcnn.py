"""Mask R-CNN inference — the port of ``bigdl_tpu/models/maskrcnn.py``
(ref: S:dllib/models/maskrcnn — MaskRCNN.scala composing the resnet
backbone, FPN.scala, RegionProposal.scala, BoxHead.scala, MaskHead.scala).

A functional params-dict model with the JAX package's keys, shapes and
initialiser scales, and its **static shapes end to end**: fixed proposal
and detection counts with validity masks, so a forward runs on the
device with no read-back (top-k, both NMS passes and ROIAlign included).
Activations are NHWC, as in the JAX model; each convolution runs on the
NCHW view of that memory (channels-last for cuDNN), and the outputs are
the JAX ones:

- ``"SAME"`` padding is XLA's: at stride 2 it pads (lo, hi) unevenly
  (the 7×7/2 stem on 224 by (2, 3), each 3×3/2 stage conv by (0, 1)),
  so the pads are explicit (``F.pad``), and the stem's max pool pads
  with −inf as ``reduce_window`` does;
- the FPN's nearest upsample is ``jax.image.resize(..., "nearest")``,
  which is torch's ``"nearest-exact"`` (``"nearest"`` parts from it at
  13 → 25);
- the mask head's transposed convolution (OIHW weights read as HWIO, no
  ``transpose_kernel``) is ``F.conv_transpose2d`` of the weight with its
  in / out axes swapped and its window flipped;
- the RPN's top-k is a stable descending sort, so tied scores keep the
  lower index first, as ``jax.lax.top_k`` does.

Training losses and sampling are out of scope, as in the JAX package.
cuDNN's TF32 default changes the convolutions' last bits on the card;
this module leaves torch's global flags as the caller set them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.nn.layers.detection import (
    clip_boxes, decode_boxes, generate_anchors, nms, roi_align)
from bigdl_tpu_torch.utils.tree import tree_map


@dataclasses.dataclass
class MaskRCNNConfig:
    num_classes: int = 81                 # COCO: 80 + background
    image_size: int = 224                 # square input (static)
    backbone_channels: Tuple[int, ...] = (64, 128, 256, 512)
    fpn_channels: int = 64
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_size_per_stride: float = 4.0   # anchor size = stride * this
    pre_nms_top_n: int = 256
    post_nms_top_n: int = 64
    rpn_nms_thresh: float = 0.7
    box_score_thresh: float = 0.05
    box_nms_thresh: float = 0.5
    detections_per_img: int = 16
    box_pool: int = 7
    mask_pool: int = 14
    mask_size: int = 28

    @classmethod
    def tiny(cls) -> "MaskRCNNConfig":
        return cls(num_classes=5, image_size=64,
                   backbone_channels=(8, 16, 32, 64), fpn_channels=16,
                   pre_nms_top_n=32, post_nms_top_n=8,
                   detections_per_img=4)

    @property
    def strides(self):
        return (4, 8, 16, 32)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _conv_p(gen, k, c_in, c_out, scale=None):
    scale = scale or float(np.sqrt(2.0 / (k * k * c_in)))
    return {"w": torch.randn((c_out, c_in, k, k), generator=gen) * scale,
            "b": torch.zeros((c_out,))}


def _fc_p(gen, n_in, n_out):
    return {"w": torch.randn((n_out, n_in), generator=gen)
            * float(np.sqrt(1.0 / n_in)),
            "b": torch.zeros((n_out,))}


def init_params(cfg: MaskRCNNConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """The JAX ``init_params`` tree (keys, shapes, scales), drawn in its
    order from a CPU ``torch.Generator`` seeded with ``seed`` and moved
    to ``device`` (``None``: the GPU): one seed gives the same weights on
    any device. JAX's bits are not reproduced; carry them with
    :func:`params_from_jax`."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    chans = cfg.backbone_channels
    f = cfg.fpn_channels
    a = len(cfg.anchor_ratios)
    params: Dict[str, Any] = {
        "stem": _conv_p(g, 7, 3, chans[0]),
        "stages": [],
        "fpn_lateral": [], "fpn_out": [],
        "rpn": {"conv": _conv_p(g, 3, f, f),
                "cls": _conv_p(g, 1, f, a),
                "reg": _conv_p(g, 1, f, a * 4)},
    }
    c_in = chans[0]
    for c in chans:
        params["stages"].append({
            "conv1": _conv_p(g, 3, c_in, c),
            "conv2": _conv_p(g, 3, c, c)})
        c_in = c
    for c in chans:
        params["fpn_lateral"].append(_conv_p(g, 1, c, f))
        params["fpn_out"].append(_conv_p(g, 3, f, f))
    p = cfg.box_pool
    params["box_head"] = {
        "fc1": _fc_p(g, f * p * p, 4 * f),
        "fc2": _fc_p(g, 4 * f, 4 * f),
        "cls": _fc_p(g, 4 * f, cfg.num_classes),
        "reg": _fc_p(g, 4 * f, cfg.num_classes * 4)}
    params["mask_head"] = {
        "convs": [_conv_p(g, 3, f, f) for _ in range(4)],
        "deconv": _conv_p(g, 2, f, f),
        "logits": _conv_p(g, 1, f, cfg.num_classes)}
    return tree_map(lambda t: t.to(dev), params)


def params_from_jax(tree, device=None) -> Dict[str, Any]:
    """The JAX parameter tree (numpy leaves, e.g. ``jax.tree_util.
    tree_map(np.asarray, params)``) as f32 tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(dev), tree)


def num_params(params) -> int:
    n = []
    tree_map(lambda t: n.append(t.numel()), params)
    return sum(n)


# ---------------------------------------------------------------------------
# building blocks (NHWC activations, convolutions on their NCHW view)
# ---------------------------------------------------------------------------

def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` (lo, hi) padding of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride=1):
    """``"SAME"`` convolution of NHWC ``x`` with OIHW ``p["w"]``, plus
    the bias."""
    w = p["w"].to(x.dtype)
    k = w.shape[-1]
    xn = x.permute(0, 3, 1, 2)
    (ht, hb), (wl, wr) = (_same_pads(xn.shape[2], k, stride),
                          _same_pads(xn.shape[3], k, stride))
    if ht == hb and wl == wr:
        y = F.conv2d(xn, w, p["b"].to(x.dtype), stride, (ht, wl))
    else:
        y = F.conv2d(F.pad(xn, (wl, wr, ht, hb)), w, p["b"].to(x.dtype),
                     stride)
    return y.permute(0, 2, 3, 1)


def _backbone(params, x) -> List[torch.Tensor]:
    """stem(s2)+pool(s2) then 4 stages -> [C2(s4), C3(s8), C4(s16), C5(s32)]."""
    x = F.relu(_conv(params["stem"], x, stride=2))
    xn = x.permute(0, 3, 1, 2)
    (ht, hb), (wl, wr) = (_same_pads(xn.shape[2], 3, 2),
                          _same_pads(xn.shape[3], 3, 2))
    x = F.max_pool2d(F.pad(xn, (wl, wr, ht, hb), value=-torch.inf),
                     3, 2).permute(0, 2, 3, 1)
    feats = []
    for i, sp in enumerate(params["stages"]):
        stride = 1 if i == 0 else 2
        x = F.relu(_conv(sp["conv1"], x, stride=stride))
        x = F.relu(_conv(sp["conv2"], x))
        feats.append(x)
    return feats


def _fpn(params, feats) -> List[torch.Tensor]:
    """Top-down pathway with lateral 1x1s (ref FPN.scala) -> [P2..P5]."""
    lats = [_conv(lp, f) for lp, f in zip(params["fpn_lateral"], feats)]
    outs = [None] * len(lats)
    top = lats[-1]
    outs[-1] = _conv(params["fpn_out"][-1], top)
    for i in range(len(lats) - 2, -1, -1):
        h, w = lats[i].shape[1:3]
        up = F.interpolate(top.permute(0, 3, 1, 2), size=(h, w),
                           mode="nearest-exact").permute(0, 2, 3, 1)
        top = lats[i] + up
        outs[i] = _conv(params["fpn_out"][i], top)
    return outs


def _fc(p, x):
    return x @ p["w"].t().to(x.dtype) + p["b"].to(x.dtype)


def _take(x, idx):
    """``x[b, idx[b]]`` for (B, N, ...) ``x`` and (B, K) ``idx``."""
    i = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, i.expand(idx.shape + x.shape[2:]))


def _top_k(scores, k):
    """``jax.lax.top_k`` over the last dim: ties keep the lower index
    first (a stable descending sort, where ``torch.topk`` may not)."""
    order = torch.sort(scores, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return torch.gather(scores, -1, order), order


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def rpn_logits(params, pyramid):
    """The RPN's objectness (B, Na) and box deltas (B, Na, 4), every
    level's anchors in NHWC order."""
    b = pyramid[0].shape[0]
    all_scores, all_deltas = [], []
    for feat in pyramid:
        t = F.relu(_conv(params["rpn"]["conv"], feat))
        all_scores.append(_conv(params["rpn"]["cls"], t).reshape(b, -1))
        all_deltas.append(_conv(params["rpn"]["reg"], t).reshape(b, -1, 4))
    return torch.cat(all_scores, 1), torch.cat(all_deltas, 1)


def _rpn_proposals(params, cfg: MaskRCNNConfig, pyramid, anchors):
    """Per-image fixed-size proposals from all FPN levels, batched over
    images: (B, P, 4) boxes, (B, P) scores (−inf where invalid), (B, P)
    validity."""
    scores, deltas = rpn_logits(params, pyramid)
    k = min(cfg.pre_nms_top_n, scores.shape[1])
    top_sc, top_i = _top_k(scores, k)
    boxes = decode_boxes(anchors[top_i], _take(deltas, top_i))
    boxes = clip_boxes(boxes, cfg.image_size, cfg.image_size)
    keep, valid = nms(boxes, top_sc, cfg.rpn_nms_thresh, cfg.post_nms_top_n)
    kept_sc = torch.gather(top_sc, 1, keep.long())
    return (_take(boxes, keep),
            torch.where(valid, kept_sc, torch.full_like(kept_sc,
                                                        -torch.inf)),
            valid)


def _assign_levels(boxes: torch.Tensor, n_levels: int) -> torch.Tensor:
    """FPN level per box by sqrt(area) (ref Pooler level mapper). The
    JAX model runs jitted, where XLA turns the division by 56 into a
    product with its f32 reciprocal: so does this, so a box one ulp
    below a level's edge lands where it lands there."""
    area = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1.0) \
        * torch.clamp(boxes[:, 3] - boxes[:, 1], min=1.0)
    lvl = torch.floor(2.0 + torch.log2(torch.sqrt(area) * (1.0 / 56.0)))
    return torch.clamp(lvl, 0, n_levels - 1).int()


def _pyramid_roi_align(pyramid, cfg, boxes, batch_idx, out_size):
    """ROIAlign from the assigned FPN level (computed on every level,
    selected per box — the JAX static-shape form of the ref Pooler, so
    a box on a level boundary pools as it does there)."""
    lvl = _assign_levels(boxes, len(pyramid))
    pooled = None
    for i, feat in enumerate(pyramid):
        p_i = roi_align(feat, boxes, batch_idx, out_size,
                        spatial_scale=1.0 / cfg.strides[i])
        sel = (lvl == i).to(p_i.dtype)[:, None, None, None]
        pooled = p_i * sel if pooled is None else pooled + p_i * sel
    return pooled


def forward(params: Dict[str, Any], cfg: MaskRCNNConfig,
            images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inference: images (B, S, S, 3) → dict of fixed-shape detections:
    boxes (B, D, 4), scores (B, D), labels (B, D) int32 (0 = background /
    invalid slot), masks (B, D, M, M) sigmoid probabilities."""
    b = images.shape[0]
    dev = images.device
    pyramid = _fpn(params, _backbone(params, images))
    anchors = torch.from_numpy(np.concatenate([
        generate_anchors(cfg.image_size // s, cfg.image_size // s, s,
                         [s * cfg.anchor_size_per_stride],
                         cfg.anchor_ratios)
        for s in cfg.strides])).to(dev)
    props, _, prop_valid = _rpn_proposals(params, cfg, pyramid, anchors)

    # ---- box head over all images' proposals at once ----------------------
    P = props.shape[1]
    flat_boxes = props.reshape(-1, 4)
    flat_batch = torch.arange(b, device=dev).repeat_interleave(P)
    pooled = _pyramid_roi_align(pyramid, cfg, flat_boxes, flat_batch,
                                cfg.box_pool)
    x = pooled.reshape(pooled.shape[0], -1)
    x = F.relu(_fc(params["box_head"]["fc1"], x))
    x = F.relu(_fc(params["box_head"]["fc2"], x))
    cls_logits = _fc(params["box_head"]["cls"], x)           # (BP, K)
    reg = _fc(params["box_head"]["reg"], x).reshape(-1, cfg.num_classes, 4)

    probs = torch.softmax(cls_logits, dim=-1)
    fg = probs[:, 1:]                      # best non-background class
    best_c = torch.argmax(fg, dim=1) + 1                     # (BP,)
    best_p = torch.amax(fg, dim=1)
    best_deltas = torch.gather(
        reg, 1, best_c[:, None, None].expand(-1, 1, 4))[:, 0]
    det_boxes = clip_boxes(decode_boxes(flat_boxes, best_deltas),
                           cfg.image_size, cfg.image_size).reshape(b, P, 4)
    det_scores = torch.where(prop_valid, best_p.reshape(b, P),
                             torch.full((b, P), -torch.inf, device=dev))
    det_labels = best_c.reshape(b, P)

    # class-aware NMS: offset boxes by label so classes never suppress
    # each other (the standard batched-NMS trick)
    off = det_labels.float()[..., None] * (2.0 * cfg.image_size)
    keep, valid = nms(det_boxes + off, det_scores, cfg.box_nms_thresh,
                      cfg.detections_per_img)
    kept_sc = torch.gather(det_scores, 1, keep.long())
    valid = valid & (kept_sc > cfg.box_score_thresh)
    f_boxes = _take(det_boxes, keep)
    f_scores = torch.where(valid, kept_sc, torch.zeros_like(kept_sc))
    f_labels = torch.where(valid, torch.gather(det_labels, 1, keep.long()),
                           torch.zeros_like(keep, dtype=det_labels.dtype))

    # ---- mask head on the final detections --------------------------------
    D = f_boxes.shape[1]
    m_boxes = f_boxes.reshape(-1, 4)
    m_batch = torch.arange(b, device=dev).repeat_interleave(D)
    mp = _pyramid_roi_align(pyramid, cfg, m_boxes, m_batch, cfg.mask_pool)
    for cp in params["mask_head"]["convs"]:
        mp = F.relu(_conv(cp, mp))
    # 2x deconv (ref: ConvTranspose 2x2 s2)
    dc = params["mask_head"]["deconv"]
    mp = F.conv_transpose2d(
        mp.permute(0, 3, 1, 2),
        dc["w"].permute(1, 0, 2, 3).flip(2, 3).to(mp.dtype),
        stride=2).permute(0, 2, 3, 1)
    mp = F.relu(mp + dc["b"].to(mp.dtype))
    mask_logits = _conv(params["mask_head"]["logits"], mp)   # (BD,M,M,K)
    lab = f_labels.reshape(-1)
    mask = torch.gather(mask_logits, 3, lab[:, None, None, None].expand(
        -1, cfg.mask_size, cfg.mask_size, 1))[..., 0]
    masks = torch.sigmoid(mask).reshape(b, D, cfg.mask_size, cfg.mask_size)
    return {"boxes": f_boxes, "scores": f_scores,
            "labels": (f_labels * valid).int(),
            "masks": masks}


class MaskRCNN:
    """Facade (ref API: models.maskrcnn.MaskRCNN(resolution=...)):
    weights from ``seed`` on ``device`` (``None``: the GPU); a call takes
    NHWC images and returns numpy arrays, as the JAX facade does."""

    def __init__(self, cfg: MaskRCNNConfig = None, seed: int = 0,
                 device=None):
        self.config = cfg or MaskRCNNConfig()
        self.device = resolve_device(device)
        self.params = init_params(self.config, seed, device=self.device)

    def __call__(self, images) -> Dict[str, np.ndarray]:
        x = torch.as_tensor(np.asarray(images, np.float32),
                            device=self.device)
        with torch.inference_mode():
            out = forward(self.params, self.config, x)
        return {k: v.cpu().numpy() for k, v in out.items()}


__all__ = ["MaskRCNN", "MaskRCNNConfig", "forward",
           "init_params", "num_params", "params_from_jax", "rpn_logits"]

"""Detection ops — the port of ``bigdl_tpu/nn/layers/detection.py`` (ref:
the Mask-RCNN support layers under ``S:dllib/nn``: RoiAlign.scala,
Nms.scala, AnchorGenerate.scala).

The JAX ops keep **static output shapes** (a fixed ``max_out`` with a
validity mask in place of a dynamic result count); so do these, so a
caller runs them on the device with no read-back: :func:`nms` is a loop
of ``max_out`` device steps, batched over images, with no ``.item()``
inside.

Conventions, as in the JAX module: boxes are absolute ``(x1, y1, x2,
y2)``; feature maps are NHWC. :func:`generate_anchors` is numpy (static
shapes), the rest take and return tensors on their input's device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.utils.table import Table


# ---------------------------------------------------------------------------
# ROI Align
# ---------------------------------------------------------------------------

def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              box_batch: torch.Tensor, output_size: int = 7,
              spatial_scale: float = 1.0,
              sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign (ref: RoiAlign.scala). ``features`` (B, H, W, C),
    ``boxes`` (N, 4) in input coordinates, ``box_batch`` (N,) the image
    of each box. Returns (N, P, P, C), P = ``output_size``: each bin the
    mean of ``sampling_ratio``² bilinear samples, taken at the sample
    point less half a pixel and clipped to the map, as the JAX op does.
    All boxes are gathered at once."""
    _, h, w, c = features.shape
    n = boxes.shape[0]
    p, s = output_size, sampling_ratio
    boxes = boxes.float() * spatial_scale
    x1, y1, x2, y2 = boxes.unbind(1)
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    grid = (torch.arange(p * s, dtype=torch.float32,
                         device=boxes.device) + 0.5) / s
    sy = y1[:, None] + grid[None, :] * (bh / p)[:, None]      # (N, p*s)
    sx = x1[:, None] + grid[None, :] * (bw / p)[:, None]
    ys = torch.clamp(sy - 0.5, 0.0, h - 1.0)
    xs = torch.clamp(sx - 0.5, 0.0, w - 1.0)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1_ = torch.clamp(y0 + 1, max=h - 1)
    x1_ = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    bi = box_batch.long()[:, None, None]

    def at(yy, xx):                                            # (N, ps, ps, C)
        return features[bi, yy[:, :, None], xx[:, None, :]]

    samp = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1_) * (1 - wy) * wx
            + at(y1_, x0) * wy * (1 - wx) + at(y1_, x1_) * wy * wx)
    return samp.reshape(n, p, s, p, s, c).mean(dim=(2, 4))


class RoiAlign(TensorModule):
    """Module wrapper (ref: nn RoiAlign layer): ``forward`` of the table
    ``[features, boxes, batch_idx]``."""

    def __init__(self, output_size: int = 7, spatial_scale: float = 1.0,
                 sampling_ratio: int = 2, name: Optional[str] = None):
        super().__init__(name)
        self.output_size = output_size
        self.spatial_scale = spatial_scale
        self.sampling_ratio = sampling_ratio

    def forward(self, x):
        feats, boxes, batch_idx = (list(x.values()) if isinstance(x, Table)
                                   else list(x))
        return roi_align(feats, boxes, torch.as_tensor(batch_idx).long(),
                         self.output_size, self.spatial_scale,
                         self.sampling_ratio)


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) → (..., N, M) IoU."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) \
        * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) \
        * torch.clamp(b[..., 3] - b[..., 1], min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5, max_out: int = 100
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS (ref: Nms.scala) with a static output size.

    ``boxes`` (N, 4) and ``scores`` (N,), or a batch (B, N, 4) / (B, N).
    Returns ``(indices (..., max_out) int32, valid (..., max_out)
    bool)``: the best surviving boxes in selection order. A step with
    nothing left selects the first index of its all −inf scores (0) and
    is not valid, as ``jnp.argmax`` does; ties go to the lower index in
    both frameworks."""
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    n = scores.shape[1]
    iou = box_iou(boxes, boxes)                                # (B, N, N)
    avail = scores.float()
    ar = torch.arange(n, device=scores.device)
    idx, valid = [], []
    for _ in range(max_out):
        best = torch.argmax(avail, dim=1)                      # (B,)
        ok = torch.gather(avail, 1, best[:, None])[:, 0] > -torch.inf
        row = torch.gather(iou, 1, best[:, None, None].expand(-1, 1, n))
        suppress = (row[:, 0] > iou_threshold) | (ar[None] == best[:, None])
        avail = torch.where(ok[:, None] & suppress,
                            torch.full_like(avail, -torch.inf), avail)
        idx.append(best)
        valid.append(ok)
    idx = torch.stack(idx, 1).int()
    valid = torch.stack(valid, 1)
    return (idx[0], valid[0]) if single else (idx, valid)


# ---------------------------------------------------------------------------
# Box codecs + anchors (ref: BboxUtil / AnchorGenerate.scala)
# ---------------------------------------------------------------------------

def encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """(dx, dy, dw, dh) regression targets of ``boxes`` w.r.t. anchors."""
    wa = anchors[:, 2] - anchors[:, 0]
    ha = anchors[:, 3] - anchors[:, 1]
    xa = anchors[:, 0] + wa * 0.5
    ya = anchors[:, 1] + ha * 0.5
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    x = boxes[:, 0] + w * 0.5
    y = boxes[:, 1] + h * 0.5
    wx, wy, ww, wh = weights
    return torch.stack([wx * (x - xa) / wa, wy * (y - ya) / ha,
                        ww * torch.log(w / wa), wh * torch.log(h / ha)], 1)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 clip: float = 4.135) -> torch.Tensor:
    """Inverse of :func:`encode_boxes` (dw / dh clamped like the ref);
    any leading dims before the last."""
    wa = anchors[..., 2] - anchors[..., 0]
    ha = anchors[..., 3] - anchors[..., 1]
    xa = anchors[..., 0] + wa * 0.5
    ya = anchors[..., 1] + ha * 0.5
    wx, wy, ww, wh = weights
    dx, dy, dw, dh = deltas.unbind(-1)
    dw = torch.clamp(dw / ww, -clip, clip)
    dh = torch.clamp(dh / wh, -clip, clip)
    x = dx / wx * wa + xa
    y = dy / wy * ha + ya
    w = torch.exp(dw) * wa
    h = torch.exp(dh) * ha
    return torch.stack([x - w * 0.5, y - h * 0.5,
                        x + w * 0.5, y + h * 0.5], -1)


def generate_anchors(feat_h: int, feat_w: int, stride: int,
                     sizes: Sequence[float],
                     ratios: Sequence[float] = (0.5, 1.0, 2.0)
                     ) -> np.ndarray:
    """Dense anchor grid for one FPN level: (H*W*A, 4) numpy (static)."""
    base = []
    for size in sizes:
        for r in ratios:
            w = size * np.sqrt(1.0 / r)
            h = size * np.sqrt(r)
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.asarray(base, np.float32)                      # (A, 4)
    cx = (np.arange(feat_w) + 0.5) * stride
    cy = (np.arange(feat_h) + 0.5) * stride
    cxg, cyg = np.meshgrid(cx, cy)                           # (H, W)
    shifts = np.stack([cxg, cyg, cxg, cyg], axis=-1)         # (H, W, 4)
    anchors = shifts[:, :, None, :] + base[None, None, :, :]
    return anchors.reshape(-1, 4).astype(np.float32)


def clip_boxes(boxes: torch.Tensor, height: float,
               width: float) -> torch.Tensor:
    """Clamp x to [0, width] and y to [0, height]; any leading dims."""
    return torch.stack([torch.clamp(boxes[..., 0], 0, width),
                        torch.clamp(boxes[..., 1], 0, height),
                        torch.clamp(boxes[..., 2], 0, width),
                        torch.clamp(boxes[..., 3], 0, height)], -1)


__all__ = ["RoiAlign", "box_iou", "clip_boxes", "decode_boxes",
           "encode_boxes", "generate_anchors", "nms", "roi_align"]

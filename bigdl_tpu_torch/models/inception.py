"""Inception-v1 / GoogLeNet — the port of ``bigdl_tpu/models/inception.py``
(ref: .../dllib/models/inception/Inception_v1.scala, the BigDL paper's
headline scaling model).

An inception module is ``nn.Concat(2)`` over four towers (1x1, 1x1 →
3x3, 1x1 → 5x5, pool → 1x1), concatenated over channels, as in the
reference and the JAX package, so the module trees (and the weights'
keys) are the JAX package's. The max-pools between stages pad SAME."""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.device import resolve_device


def _tower(*mods) -> nn.Sequential:
    seq = nn.Sequential()
    for m in mods:
        seq.add(m)
    return seq


def _conv(n_in, n_out, k, stride=1, pad=0) -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.SpatialConvolution(n_in, n_out, k, k, stride, stride,
                                       pad, pad))
            .add(nn.ReLU()))


def inception_module(n_in: int, c1: int, c3r: int, c3: int, c5r: int,
                     c5: int, pool_proj: int) -> nn.Concat:
    """ref: Inception_Layer_v1(inputSize, config, namePrefix)."""
    return (nn.Concat(2)
            .add(_conv(n_in, c1, 1))
            .add(_tower(_conv(n_in, c3r, 1), _conv(c3r, c3, 3, 1, 1)))
            .add(_tower(_conv(n_in, c5r, 1), _conv(c5r, c5, 5, 1, 2)))
            .add(_tower(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1),
                        _conv(n_in, pool_proj, 1))))


def inception_v1(class_num: int = 1000, device=None) -> nn.Sequential:
    """The GoogLeNet trunk (no aux heads; ref Inception_v1_NoAuxClassifier)
    on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    return (nn.Sequential()
            .add(_conv(3, 64, 7, 2, 3))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2, -1, -1))
            .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(_conv(64, 64, 1))
            .add(_conv(64, 192, 3, 1, 1))
            .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2, -1, -1))
            .add(inception_module(192, 64, 96, 128, 16, 32, 32))    # 3a: 256
            .add(inception_module(256, 128, 128, 192, 32, 96, 64))  # 3b: 480
            .add(nn.SpatialMaxPooling(3, 3, 2, 2, -1, -1))
            .add(inception_module(480, 192, 96, 208, 16, 48, 64))   # 4a: 512
            .add(inception_module(512, 160, 112, 224, 24, 64, 64))  # 4b
            .add(inception_module(512, 128, 128, 256, 24, 64, 64))  # 4c
            .add(inception_module(512, 112, 144, 288, 32, 64, 64))  # 4d: 528
            .add(inception_module(528, 256, 160, 320, 32, 128, 128))  # 4e: 832
            .add(nn.SpatialMaxPooling(3, 3, 2, 2, -1, -1))
            .add(inception_module(832, 256, 160, 320, 32, 128, 128))  # 5a
            .add(inception_module(832, 384, 192, 384, 48, 128, 128))  # 5b:1024
            .add(nn.GlobalAveragePooling2D())
            .add(nn.Dropout(0.4))
            .add(nn.Linear(1024, class_num))
            .add(nn.LogSoftMax())).to(dev)


build_model = inception_v1

"""VGG — the port of ``bigdl_tpu/models/vgg.py`` (ref:
.../dllib/models/vgg/VggForCifar10.scala and the VGG-16 ImageNet graph of
the reference's examples)."""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.device import resolve_device


def _conv_relu(n_in, n_out):
    return (nn.Sequential()
            .add(nn.SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1))
            .add(nn.ReLU()))


def vgg_cifar(class_num: int = 10, device=None) -> nn.Sequential:
    """ref: VggForCifar10 — conv-BN stacks over 32x32 with a 512-wide
    head, on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    def conv_bn(n_in, n_out):
        return (nn.Sequential()
                .add(nn.SpatialConvolution(n_in, n_out, 3, 3, 1, 1, 1, 1))
                .add(nn.SpatialBatchNormalization(n_out))
                .add(nn.ReLU()))

    model = nn.Sequential()
    cfg = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M",
           (128, 256), (256, 256), (256, 256), "M",
           (256, 512), (512, 512), (512, 512), "M",
           (512, 512), (512, 512), (512, 512), "M"]
    for c in cfg:
        if c == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            model.add(conv_bn(*c))
    return (model
            .add(nn.Flatten())
            .add(nn.Linear(512, 512))
            .add(nn.BatchNormalization(512))
            .add(nn.ReLU())
            .add(nn.Dropout(0.5))
            .add(nn.Linear(512, class_num))
            .add(nn.LogSoftMax())).to(dev)


def vgg16(class_num: int = 1000, device=None) -> nn.Sequential:
    """VGG-16 ImageNet, 224x224 NCHW, on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    model = nn.Sequential()
    cfg = [(3, 64), (64, 64), "M", (64, 128), (128, 128), "M",
           (128, 256), (256, 256), (256, 256), "M",
           (256, 512), (512, 512), (512, 512), "M",
           (512, 512), (512, 512), (512, 512), "M"]
    for c in cfg:
        if c == "M":
            model.add(nn.SpatialMaxPooling(2, 2, 2, 2))
        else:
            model.add(_conv_relu(*c))
    return (model
            .add(nn.Flatten())
            .add(nn.Linear(512 * 7 * 7, 4096))
            .add(nn.ReLU())
            .add(nn.Dropout(0.5))
            .add(nn.Linear(4096, 4096))
            .add(nn.ReLU())
            .add(nn.Dropout(0.5))
            .add(nn.Linear(4096, class_num))
            .add(nn.LogSoftMax())).to(dev)


build_model = vgg_cifar

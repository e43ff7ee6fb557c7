"""LeNet-5 — the port of ``bigdl_tpu/models/lenet.py`` (ref:
.../dllib/models/lenet/LeNet5.scala, the canonical BigDL hello-world,
BASELINE config 1)."""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.device import resolve_device


def build_model(class_num: int = 10, device=None) -> nn.Sequential:
    """ref LeNet5.apply: conv(1→6,5x5) tanh pool conv(6→12,5x5) tanh pool
    fc(12*4*4→100) tanh fc(100→classNum) logsoftmax; on ``device``
    (``None``: the GPU)."""
    dev = resolve_device(device)
    return (nn.Sequential()
            .add(nn.Reshape([1, 28, 28]))
            .add(nn.SpatialConvolution(1, 6, 5, 5).set_name("conv1_5x5"))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.SpatialConvolution(6, 12, 5, 5).set_name("conv2_5x5"))
            .add(nn.Tanh())
            .add(nn.SpatialMaxPooling(2, 2, 2, 2))
            .add(nn.Reshape([12 * 4 * 4]))
            .add(nn.Linear(12 * 4 * 4, 100).set_name("fc_1"))
            .add(nn.Tanh())
            .add(nn.Linear(100, class_num).set_name("fc_2"))
            .add(nn.LogSoftMax())).to(dev)

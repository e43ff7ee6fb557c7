"""ResNet — the port of ``bigdl_tpu/models/resnet.py`` (ref:
.../dllib/models/resnet/ResNet.scala: CIFAR-10 basic-block variants and
the ImageNet bottleneck variants incl. ResNet-50, BASELINE config 2).

Residual blocks are ConcatTable(path, shortcut) → CAddTable → ReLU, as
in the reference and the JAX package, so the module trees (and the
weights' keys) are the JAX package's. Convs pad SAME (``pad = -1``),
asymmetric at stride 2 as XLA does.
"""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.device import resolve_device


def conv_bn(n_in: int, n_out: int, k: int, stride: int = 1,
            pad: int = -1, relu: bool = True,
            format: str = "NCHW") -> nn.Sequential:
    seq = (nn.Sequential()
           .add(nn.SpatialConvolution(n_in, n_out, k, k, stride, stride,
                                      pad, pad, with_bias=False,
                                      format=format))
           .add(nn.SpatialBatchNormalization(n_out, format=format)))
    if relu:
        seq.add(nn.ReLU())
    return seq


def _shortcut(n_in: int, n_out: int, stride: int,
              format: str = "NCHW") -> nn.Module:
    if n_in != n_out or stride != 1:
        # type-B projection shortcut (1x1 conv + BN), the reference default
        return (nn.Sequential()
                .add(nn.SpatialConvolution(n_in, n_out, 1, 1, stride, stride,
                                           0, 0, with_bias=False,
                                           format=format))
                .add(nn.SpatialBatchNormalization(n_out, format=format)))
    return nn.Identity()


def _residual(path: nn.Module, shortcut: nn.Module) -> nn.Sequential:
    return (nn.Sequential()
            .add(nn.ConcatTable().add(path).add(shortcut))
            .add(nn.CAddTable())
            .add(nn.ReLU()))


def basic_block(n_in: int, n_out: int, stride: int = 1,
                format: str = "NCHW") -> nn.Sequential:
    path = (nn.Sequential()
            .add(conv_bn(n_in, n_out, 3, stride, format=format))
            .add(conv_bn(n_out, n_out, 3, 1, relu=False, format=format)))
    return _residual(path, _shortcut(n_in, n_out, stride, format))


def bottleneck(n_in: int, n_mid: int, stride: int = 1,
               expansion: int = 4, format: str = "NCHW") -> nn.Sequential:
    n_out = n_mid * expansion
    path = (nn.Sequential()
            .add(conv_bn(n_in, n_mid, 1, 1, 0, format=format))
            .add(conv_bn(n_mid, n_mid, 3, stride, format=format))
            .add(conv_bn(n_mid, n_out, 1, 1, 0, relu=False, format=format)))
    return _residual(path, _shortcut(n_in, n_out, stride, format))


def resnet_cifar(depth: int = 20, class_num: int = 10,
                 device=None) -> nn.Sequential:
    """CIFAR-10 ResNet (ref: ResNet.apply with dataSet=CIFAR-10): depth =
    6n+2 basic blocks over 16/32/64 channels on 32x32 inputs."""
    if (depth - 2) % 6 != 0:
        raise ValueError("cifar resnet depth must be 6n+2")
    dev = resolve_device(device)
    n = (depth - 2) // 6
    model = nn.Sequential().add(conv_bn(3, 16, 3, 1))
    for c_in, c_out, stride in [(16, 16, 1), (16, 32, 2), (32, 64, 2)]:
        model.add(basic_block(c_in, c_out, stride))
        for _ in range(n - 1):
            model.add(basic_block(c_out, c_out, 1))
    return (model
            .add(nn.GlobalAveragePooling2D())
            .add(nn.Linear(64, class_num))
            .add(nn.LogSoftMax())).to(dev)


_IMAGENET_CFG = {
    50: (bottleneck, (3, 4, 6, 3)),
    101: (bottleneck, (3, 4, 23, 3)),
    152: (bottleneck, (3, 8, 36, 3)),
    18: (basic_block, (2, 2, 2, 2)),
    34: (basic_block, (3, 4, 6, 3)),
}


def resnet_imagenet(depth: int = 50, class_num: int = 1000,
                    format: str = "NCHW", remat: bool = False,
                    device=None) -> nn.Sequential:
    """ImageNet ResNet (ref: ResNet.apply with dataSet=ImageNet), 224x224
    input. ``format="NHWC"`` builds the channels-last variant;
    ``remat=True`` wraps each residual block in ``nn.Checkpoint``
    (recomputed in backward instead of saved)."""
    if depth not in _IMAGENET_CFG:
        raise ValueError(f"unsupported depth {depth}")
    dev = resolve_device(device)
    block, stages = _IMAGENET_CFG[depth]
    expansion = 4 if block is bottleneck else 1
    wrap = (lambda m: nn.Checkpoint(m)) if remat else (lambda m: m)
    model = (nn.Sequential()
             .add(conv_bn(3, 64, 7, 2, format=format))
             .add(nn.SpatialMaxPooling(3, 3, 2, 2, -1, -1, format=format)))
    n_in, width = 64, 64
    for stage_idx, n_blocks in enumerate(stages):
        stride = 1 if stage_idx == 0 else 2
        model.add(wrap(block(n_in, width, stride, format=format)))
        n_in = width * expansion
        for _ in range(n_blocks - 1):
            model.add(wrap(block(n_in, width, 1, format=format)))
        width *= 2
    return (model
            .add(nn.GlobalAveragePooling2D(format=format))
            .add(nn.Linear(n_in, class_num))
            .add(nn.LogSoftMax())).to(dev)


def build_model(depth: int = 50, class_num: int = 1000,
                dataset: str = "imagenet", device=None) -> nn.Sequential:
    if dataset == "cifar10":
        return resnet_cifar(depth if depth != 50 else 20, class_num,
                            device=device)
    return resnet_imagenet(depth, class_num, device=device)

"""Composable sample transformers — the port of
``bigdl_tpu/feature/transformers.py`` (ref:
.../feature/dataset/Transformer.scala and the image / text transformer
families: BytesToGreyImg, GreyImgNormalizer, GreyImgToSample, HFlip).

A Transformer maps an iterator to an iterator; ``a >> b`` composes (the
reference uses Scala's ``->``). Host numpy; the random ones draw from a
seeded ``numpy`` ``RandomState``, so they give the JAX package's bits.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from bigdl_tpu_torch.feature.dataset import Sample


class Transformer:
    def __call__(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)


class ChainedTransformer(Transformer):
    def __init__(self, *transformers):
        self.transformers = list(transformers)

    def __call__(self, it):
        for t in self.transformers:
            it = t(it)
        return it


class MapTransformer(Transformer):
    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, it):
        for x in it:
            yield self.fn(x)


class Normalizer(Transformer):
    """Per-sample (x - mean) / std on feature 0 (ref: GreyImgNormalizer)."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = mean, std

    def __call__(self, it):
        for s in it:
            feats = [(s.features[0].astype(np.float32) - self.mean) / self.std]
            feats += s.features[1:]
            yield Sample(feats, s.labels)


class OneHot(Transformer):
    """Label → one-hot vector (keras-style categorical targets)."""

    def __init__(self, n_classes: int, zero_based: bool = False):
        self.n_classes = n_classes
        self.zero_based = zero_based

    def __call__(self, it):
        for s in it:
            lab = int(np.asarray(s.labels[0]).reshape(()))
            if not self.zero_based:
                lab -= 1
            oh = np.zeros((self.n_classes,), np.float32)
            oh[lab] = 1.0
            yield Sample(s.features, [oh])


class HFlip(Transformer):
    """Random horizontal flip of HW or CHW images (ref: vision HFlip)."""

    def __init__(self, p: float = 0.5, seed: int = 0):
        self.p = p
        self.rng = np.random.RandomState(seed)

    def __call__(self, it):
        for s in it:
            if self.rng.rand() < self.p:
                img = s.features[0]
                yield Sample([np.ascontiguousarray(img[..., ::-1])]
                             + s.features[1:], s.labels)
            else:
                yield s


class RandomCrop(Transformer):
    """Random crop with padding (ref: vision RandomCropper)."""

    def __init__(self, height: int, width: int, padding: int = 0,
                 seed: int = 0):
        self.h, self.w, self.pad = height, width, padding
        self.rng = np.random.RandomState(seed)

    def __call__(self, it):
        for s in it:
            img = s.features[0]  # CHW or HW
            chw = img.ndim == 3
            if self.pad:
                widths = ((0, 0),) * (img.ndim - 2) + \
                    ((self.pad, self.pad), (self.pad, self.pad))
                img = np.pad(img, widths)
            H, W = img.shape[-2], img.shape[-1]
            top = self.rng.randint(0, H - self.h + 1)
            left = self.rng.randint(0, W - self.w + 1)
            crop = img[..., top:top + self.h, left:left + self.w]
            yield Sample([crop] + s.features[1:], s.labels)

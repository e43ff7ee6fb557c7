"""ImageFrame / ImageFeature — the port of
``bigdl_tpu/feature/vision/image_frame.py`` (ref:
vision/image/ImageFrame.scala, ImageFeature.scala: a keyed feature map
per image flowing through transformers; a local frame)."""

from __future__ import annotations

import glob as _glob
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class ImageFeature(dict):
    """Keyed per-image state (ref keys kept: bytes/mat/floats/sample/
    label/uri/originalSize)."""

    BYTES = "bytes"
    MAT = "mat"          # HWC uint8/float numpy (the "OpenCVMat")
    FLOATS = "floats"
    SAMPLE = "sample"
    LABEL = "label"
    URI = "uri"
    ORIGINAL_SIZE = "originalSize"

    def __init__(self, data: Optional[bytes] = None,
                 label=None, uri: Optional[str] = None, **kwargs):
        super().__init__(**kwargs)
        if data is not None:
            self[self.BYTES] = data
        if label is not None:
            self[self.LABEL] = label
        if uri is not None:
            self[self.URI] = uri

    def get_image(self) -> Optional[np.ndarray]:
        return self.get(self.MAT)

    def get_label(self):
        return self.get(self.LABEL)


class ImageFrame:
    """Factory facade (ref: object ImageFrame — read/readParquet,
    fromImageFeature arrays; isLocal/isDistributed)."""

    @staticmethod
    def read(path: str, min_partitions: int = 1) -> "LocalImageFrame":
        """Read image file(s); glob patterns supported."""
        files = sorted(_glob.glob(path))
        if not files and os.path.exists(path):
            files = [path]
        feats = []
        for f in files:
            with open(f, "rb") as fh:
                feats.append(ImageFeature(data=fh.read(), uri=f))
        return LocalImageFrame(feats)

    @staticmethod
    def from_arrays(images: Sequence[np.ndarray],
                    labels: Optional[Sequence] = None) -> "LocalImageFrame":
        feats = []
        for i, img in enumerate(images):
            f = ImageFeature()
            f[ImageFeature.MAT] = np.asarray(img)
            f[ImageFeature.ORIGINAL_SIZE] = np.asarray(img).shape
            if labels is not None:
                f[ImageFeature.LABEL] = labels[i]
            feats.append(f)
        return LocalImageFrame(feats)


class LocalImageFrame(ImageFrame):
    """ref: LocalImageFrame — array-backed frame."""

    def __init__(self, features: List[ImageFeature]):
        self.features = list(features)

    def transform(self, transformer) -> "LocalImageFrame":
        self.features = [transformer(f) for f in self.features]
        return self

    __rshift__ = transform

    def is_local(self) -> bool:
        return True

    def is_distributed(self) -> bool:
        return False

    def get_image(self) -> List[np.ndarray]:
        return [f.get_image() for f in self.features]

    def get_label(self) -> List:
        return [f.get_label() for f in self.features]

    def to_samples(self):
        from bigdl_tpu_torch.feature.dataset import Sample

        out = []
        for f in self.features:
            if ImageFeature.SAMPLE in f:
                out.append(f[ImageFeature.SAMPLE])
            else:
                out.append(Sample(f[ImageFeature.FLOATS]
                                  if ImageFeature.FLOATS in f
                                  else f[ImageFeature.MAT],
                                  f.get(ImageFeature.LABEL)))
        return out

    def __len__(self):
        return len(self.features)

"""ImageNet directory-format reader — the port of
``bigdl_tpu/feature/imagenet.py`` (ref: the reference reads ImageNet as
Hadoop sequence files, ``models/inception/ImageNet2012.scala``, with an
OpenCV JNI augment chain). Decode and augment stay on the host:
class-per-subdirectory JPEGs, PIL decode (imported when a file is read),
streaming Samples; the optimizer's prefetcher overlaps them with the
card's step, and its ``data`` timer shows what it does not hide.

Layout::

    root/train/n01440764/xxx.JPEG
    root/val/n01440764/yyy.JPEG

Labels are 1-based class indices in sorted-directory order (the
reference's convention).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.feature.dataset import AbstractDataSet, Sample

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_EXTS = (".jpeg", ".jpg", ".png", ".bmp")


def _normalize(chw: np.ndarray) -> np.ndarray:
    return ((chw - IMAGENET_MEAN[:, None, None])
            / IMAGENET_STD[:, None, None]).astype(np.float32)


class ImageFolderDataSet(AbstractDataSet):
    """Streaming class-per-subdir image dataset: decode + augment on the
    host per sample (never materializes the full set in memory)."""

    def __init__(self, root: str, image_size: int = 224,
                 train: bool = True, seed: int = 0,
                 class_names: Optional[List[str]] = None):
        self.root = root
        self.image_size = image_size
        self.train = train
        self._rng = np.random.RandomState(seed)
        classes = class_names or sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.class_names = classes
        self.files: List[Tuple[str, int]] = []
        for idx, cls in enumerate(classes):
            cdir = os.path.join(root, cls)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(_EXTS):
                    # 1-based labels, reference convention
                    self.files.append((os.path.join(cdir, fn), idx + 1))

    def size(self) -> int:
        return len(self.files)

    def _load(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB")
        s = self.image_size
        if self.train:
            # inception-style random resized crop (area 0.3..1)
            w, h = img.size
            for _ in range(5):
                area = w * h * self._rng.uniform(0.3, 1.0)
                ar = self._rng.uniform(3 / 4, 4 / 3)
                cw = int(round(np.sqrt(area * ar)))
                ch = int(round(np.sqrt(area / ar)))
                if cw <= w and ch <= h:
                    x0 = self._rng.randint(0, w - cw + 1)
                    y0 = self._rng.randint(0, h - ch + 1)
                    img = img.crop((x0, y0, x0 + cw, y0 + ch))
                    break
            img = img.resize((s, s), Image.BILINEAR)
            arr = np.asarray(img, np.float32) / 255.0
            if self._rng.rand() < 0.5:
                arr = arr[:, ::-1]
        else:
            # resize shorter side to s*1.14 then center crop
            w, h = img.size
            scale = int(s * 1.14) / min(w, h)
            img = img.resize((max(s, int(w * scale)),
                              max(s, int(h * scale))), Image.BILINEAR)
            w, h = img.size
            x0, y0 = (w - s) // 2, (h - s) // 2
            img = img.crop((x0, y0, x0 + s, y0 + s))
            arr = np.asarray(img, np.float32) / 255.0
        chw = np.ascontiguousarray(arr.transpose(2, 0, 1))
        return _normalize(chw)

    def data(self, train: bool = True):
        order = np.arange(len(self.files))
        if train and self.train:
            self._rng.shuffle(order)
        for i in order:
            path, label = self.files[i]
            yield Sample(self._load(path), np.float32(label))


def synthetic_imagenet_dataset(n: int = 256, classes: int = 1000,
                               image_size: int = 224, seed: int = 0):
    """A streaming synthetic stand-in with ImageNet shapes (no files
    needed): images drawn on the host, one a sample, 1-based labels."""
    from bigdl_tpu_torch.feature.dataset import LocalDataSet

    rs = np.random.RandomState(seed)
    labels = (rs.randint(0, classes, n) + 1).astype(np.float32)

    class _Synthetic(AbstractDataSet):
        def size(self):
            return n

        def data(self, train: bool = True):
            order = rs.permutation(n) if train else np.arange(n)
            for i in order:
                img = rs.rand(3, image_size, image_size).astype(np.float32)
                yield Sample(_normalize(img), labels[i])

    return _Synthetic()

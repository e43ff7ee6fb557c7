"""CIFAR-10/100 readers — the port of ``bigdl_tpu/feature/cifar.py`` (ref:
the reference ships CIFAR loaders with its models;
``models/resnet/Utils.scala`` reads the CIFAR binary format).

Binary layout (the "binary version" distribution):
- CIFAR-10:  per record ``1 label byte + 3072 image bytes`` (R,G,B planes
  of 32x32), files ``data_batch_{1..5}.bin`` / ``test_batch.bin``
- CIFAR-100: per record ``1 coarse + 1 fine label byte + 3072 bytes``,
  files ``train.bin`` / ``test.bin``

With no files on disk and ``synthetic=True`` (the default) a
deterministic per-class color-patch set is generated, so training
pipelines run end to end.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# per-channel statistics of the real CIFAR-10 training set
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _read_bin(path: str, label_bytes: int) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, np.uint8)
    rec = label_bytes + 3072
    if raw.size % rec:
        raise ValueError(f"{path}: size {raw.size} not a multiple of {rec}")
    raw = raw.reshape(-1, rec)
    labels = raw[:, label_bytes - 1].astype(np.float32)  # fine label last
    imgs = raw[:, label_bytes:].reshape(-1, 3, 32, 32).astype(np.float32)
    return imgs / 255.0, labels + 1.0                    # 1-based


def _protos(classes: int) -> np.ndarray:
    protos = np.zeros((classes, 3, 32, 32), np.float32)
    for k in range(classes):
        prs = np.random.RandomState(2000 + k)
        for _ in range(5):
            r, c = prs.randint(2, 26, 2)
            ch = prs.randint(0, 3)
            protos[k, ch, r:r + 6, c:c + 6] += prs.rand() * 0.8 + 0.4
        protos[k] = np.clip(protos[k], 0, 1)
    return protos


_HARD_SIGMA: dict = {}


def _synthetic_cifar(n: int, classes: int, seed: int,
                     hard: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    rs = np.random.RandomState(seed)
    protos = _protos(classes)
    if hard:
        # Bayes-calibrated noise (see feature.mnist.calibrate_sigma):
        # pins the nearest-prototype ceiling at ~0.955 so the
        # convergence benchmark's accuracy is falsifiable
        from bigdl_tpu_torch.feature.mnist import calibrate_sigma
        if classes not in _HARD_SIGMA:
            _HARD_SIGMA[classes] = calibrate_sigma(protos)
        sigma = _HARD_SIGMA[classes]
    else:
        sigma = 0.1
    labels = rs.randint(0, classes, n)
    imgs = protos[labels] + sigma * rs.randn(n, 3, 32, 32).astype(np.float32)
    return (np.clip(imgs, 0, 1).astype(np.float32),
            (labels + 1).astype(np.float32))


def nearest_prototype_accuracy(images: np.ndarray, labels: np.ndarray,
                               classes: int = 10) -> float:
    """Top-1 of the nearest-prototype classifier (the Bayes anchor the
    convergence bench reports; labels 1-based). Shares the mnist
    implementation — the math must not diverge between the two benches."""
    from bigdl_tpu_torch.feature.mnist import _nearest_prototype_accuracy
    return _nearest_prototype_accuracy(_protos(classes), images, labels)


def load_cifar(folder: Optional[str] = None, train: bool = True,
               classes: int = 10, synthetic_size: int = 2048,
               seed: int = 0, hard: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,3,32,32) float32 in [0,1], labels (N,) 1-based).

    Reads the binary distribution from ``folder`` when present; otherwise
    generates the synthetic set.
    """
    if folder:
        if classes == 10:
            names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
                     if train else ["test_batch.bin"])
            label_bytes = 1
        else:
            names = ["train.bin" if train else "test.bin"]
            label_bytes = 2
        paths = [os.path.join(folder, n) for n in names]
        if all(os.path.exists(p) for p in paths):
            parts = [_read_bin(p, label_bytes) for p in paths]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
    return _synthetic_cifar(synthetic_size, classes,
                            seed if train else seed + 1, hard=hard)


def normalizer(x: np.ndarray) -> np.ndarray:
    """Channel normalization with the canonical CIFAR-10 statistics."""
    return ((x - CIFAR10_MEAN[:, None, None])
            / CIFAR10_STD[:, None, None]).astype(np.float32)


def train_transformer(pad: int = 4, seed: int = 0):
    """Standard CIFAR augmentation chain as a Sample transformer:
    reflect-pad + random crop + random hflip + normalize."""
    from bigdl_tpu_torch.feature.dataset import Sample
    from bigdl_tpu_torch.feature.transformers import MapTransformer

    rs = np.random.RandomState(seed)

    def aug(s: Sample) -> Sample:
        x = s.features[0]
        x = np.pad(x, ((0, 0), (pad, pad), (pad, pad)), mode="reflect")
        r, c = rs.randint(0, 2 * pad + 1, 2)
        x = x[:, r:r + 32, c:c + 32]
        if rs.rand() < 0.5:
            x = x[:, :, ::-1]
        return Sample(normalizer(np.ascontiguousarray(x)), s.labels)

    return MapTransformer(aug)


def eval_transformer():
    from bigdl_tpu_torch.feature.dataset import Sample
    from bigdl_tpu_torch.feature.transformers import MapTransformer

    return MapTransformer(
        lambda s: Sample(normalizer(s.features[0]), s.labels))


def cifar_dataset(folder: Optional[str] = None, train: bool = True,
                  classes: int = 10, synthetic_size: int = 2048,
                  seed: int = 0, augment: bool = True):
    """LocalDataSet with the standard transform chain attached."""
    from bigdl_tpu_torch.feature.dataset import LocalDataSet

    x, y = load_cifar(folder, train, classes, synthetic_size, seed)
    ds = LocalDataSet(x, y, shuffle=train, seed=seed)
    return ds.transform(train_transformer(seed=seed) if (train and augment)
                        else eval_transformer())

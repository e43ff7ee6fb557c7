"""MNIST loader — the port of ``bigdl_tpu/feature/mnist.py`` (ref: .../models/lenet/Utils.scala load idx files +
BytesToGreyImg/GreyImgNormalizer transformer chain).

Reads idx-format files from ``folder`` when present (train-images-idx3-ubyte
etc.). With no files and ``synthetic=True`` (default in this offline
environment), generates a deterministic synthetic digit set: each class is
a fixed stroke pattern + noise — linearly separable enough for LeNet to
reach high accuracy fast, which is what the hello-world config needs.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

TRAIN_MEAN = 0.13066047740239506
TRAIN_STD = 0.3081078


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _protos() -> np.ndarray:
    protos = np.zeros((10, 28, 28), np.float32)
    for k in range(10):
        prs = np.random.RandomState(1000 + k)
        # distinct blob pattern per class
        for _ in range(6):
            r, c = prs.randint(4, 22, 2)
            protos[k, r:r + 5, c:c + 5] += prs.rand() + 0.5
        protos[k] = np.clip(protos[k], 0, 1)
    return protos


def calibrate_sigma(protos: np.ndarray, target: float = 0.96,
                    n: int = 4096, seed: int = 123) -> float:
    """Noise level such that the Bayes-optimal-style nearest-prototype
    classifier on the clipped noisy draw scores ≈ ``target`` top-1
    (the easy sets saturate at 1.0, which cannot falsify a subtly broken
    optimizer — the ``hard`` sets pin the ceiling below 1 by
    construction). Nearest-mean is exactly Bayes for
    isotropic equal-variance Gaussian classes pre-clip; post-clip it is
    a tight reference anchor."""
    c = protos.shape[0]
    pf = protos.reshape(c, -1).astype(np.float32)
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, c, n)
    noise = rs.randn(n, pf.shape[1]).astype(np.float32)
    pn = (pf * pf).sum(1)
    lo, hi = 0.02, 3.0
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        x = np.clip(pf[labels] + mid * noise, 0.0, 1.0)
        d = pn[None, :] - 2.0 * (x @ pf.T)      # argmin == full distance
        acc = float((d.argmin(1) == labels).mean())
        if acc > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


_HARD_SIGMA: dict = {}


def _synthetic_digits(n: int, seed: int,
                      hard: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    rs = np.random.RandomState(seed)
    protos = _protos()
    if hard:
        if "sigma" not in _HARD_SIGMA:
            _HARD_SIGMA["sigma"] = calibrate_sigma(protos)
        sigma = _HARD_SIGMA["sigma"]
    else:
        sigma = 0.15
    labels = rs.randint(0, 10, n)
    imgs = protos[labels] + sigma * rs.randn(n, 28, 28).astype(np.float32)
    imgs = np.clip(imgs, 0, 1)
    return imgs.astype(np.float32), (labels + 1).astype(np.float32)  # 1-based


def _nearest_prototype_accuracy(protos: np.ndarray, images: np.ndarray,
                                labels: np.ndarray) -> float:
    """Shared nearest-prototype top-1 (labels 1-based) — single source
    for the mnist AND cifar Bayes anchors."""
    pf = protos.reshape(len(protos), -1)
    x = images.reshape(len(images), -1)
    d = (pf * pf).sum(1)[None, :] - 2.0 * (x @ pf.T)
    return float((d.argmin(1) == (labels - 1).astype(np.int64)).mean())


def nearest_prototype_accuracy(images: np.ndarray,
                               labels: np.ndarray) -> float:
    """Top-1 of the nearest-prototype classifier on a synthetic draw —
    the Bayes reference the convergence bench reports next to the
    trained model's accuracy (labels 1-based)."""
    return _nearest_prototype_accuracy(_protos(), images, labels)


def load_mnist(folder: Optional[str] = None, train: bool = True,
               synthetic_size: int = 2048, seed: int = 0,
               hard: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N,28,28) float32 in [0,1], labels (N,) float32 1-based).

    ``hard=True`` selects the Bayes-calibrated synthetic set (top-1
    ceiling ≈0.96 by construction) used by the convergence benchmarks;
    the default easy set stays for hello-world smoke paths."""
    if folder:
        prefix = "train" if train else "t10k"
        for ext in ("", ".gz"):
            ip = os.path.join(folder, f"{prefix}-images-idx3-ubyte{ext}")
            lp = os.path.join(folder, f"{prefix}-labels-idx1-ubyte{ext}")
            if os.path.exists(ip) and os.path.exists(lp):
                images = _read_idx(ip).astype(np.float32) / 255.0
                labels = _read_idx(lp).astype(np.float32) + 1.0
                return images, labels
    return _synthetic_digits(synthetic_size, seed if train else seed + 1,
                             hard=hard)


def normalize(images: np.ndarray) -> np.ndarray:
    """ref: GreyImgNormalizer(trainMean, trainStd)."""
    return (images - TRAIN_MEAN) / TRAIN_STD

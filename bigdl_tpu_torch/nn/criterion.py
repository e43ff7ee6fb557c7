"""Criterions — the port of ``bigdl_tpu/nn/criterion.py`` (ref:
.../nn/ClassNLLCriterion.scala, CrossEntropyCriterion.scala,
MSECriterion.scala, BCECriterion.scala, ...): each ``apply_loss`` is
the JAX one's formula on tensors; ``backward`` is autograd (see
:class:`~bigdl_tpu_torch.nn.module.Criterion`).

Class-index targets are **1-based** as in the reference: a target of
``k`` selects log-prob column ``k-1`` (the MNIST loader's labels are
1-based); ``zero_based_label=True`` switches to 0-based.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Criterion
from bigdl_tpu_torch.utils.table import Table


def _class_index(target, zero_based: bool):
    idx = torch.as_tensor(target).to(torch.int64)
    if idx.dim() > 1:
        idx = idx.reshape(idx.shape[0])
    return idx if zero_based else idx - 1


def _reduce(loss, size_average: bool):
    return loss.mean() if size_average else loss.sum()


def _weights(weights):
    return None if weights is None else \
        torch.as_tensor(np.asarray(weights), dtype=torch.float32)


def _nll(logp, target, weights, zero_based, size_average):
    idx = _class_index(target, zero_based).to(logp.device)
    picked = logp.gather(1, idx[:, None])[:, 0]
    if weights is not None:
        w = weights.to(logp.device)[idx]
        loss = -(picked * w).sum()
        return loss / w.sum() if size_average else loss
    return -picked.mean() if size_average else -picked.sum()


class ClassNLLCriterion(Criterion):
    """NLL over log-probabilities (ref: nn/ClassNLLCriterion.scala);
    with LogSoftMax, the LeNet / ResNet training loss."""

    def __init__(self, weights=None, size_average: bool = True,
                 logProbAsInput: bool = True, zero_based_label: bool = False):
        super().__init__(size_average)
        self.weights = _weights(weights)
        self.log_prob_as_input = logProbAsInput
        self.zero_based = zero_based_label

    def apply_loss(self, x, target):
        logp = x if self.log_prob_as_input else torch.log(x + 1e-8)
        return _nll(logp, target, self.weights, self.zero_based,
                    self.size_average)


class CrossEntropyCriterion(Criterion):
    """LogSoftMax + ClassNLL fused (ref: nn/CrossEntropyCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True,
                 zero_based_label: bool = False):
        super().__init__(size_average)
        self.weights = _weights(weights)
        self.zero_based = zero_based_label

    def apply_loss(self, x, target):
        return _nll(torch.log_softmax(x, dim=-1), target, self.weights,
                    self.zero_based, self.size_average)


class CategoricalCrossEntropy(Criterion):
    """One-hot-target cross entropy over probabilities (keras parity)."""

    def apply_loss(self, x, target):
        loss = -(target * torch.log(torch.clamp(x, 1e-8, 1.0))).sum(-1)
        return _reduce(loss, self.size_average)


class MSECriterion(Criterion):
    def apply_loss(self, x, target):
        return _reduce((x - target) ** 2, self.size_average)


class AbsCriterion(Criterion):
    def apply_loss(self, x, target):
        return _reduce(torch.abs(x - target), self.size_average)


L1Cost = AbsCriterion


class SmoothL1Criterion(Criterion):
    def __init__(self, size_average: bool = True, sigma: float = 1.0):
        super().__init__(size_average)
        self.sigma = sigma

    def apply_loss(self, x, target):
        s2 = self.sigma * self.sigma
        d = torch.abs(x - target)
        loss = torch.where(d < 1.0 / s2, 0.5 * s2 * d * d, d - 0.5 / s2)
        return _reduce(loss, self.size_average)


class BCECriterion(Criterion):
    """Binary cross entropy over probabilities (ref: nn/BCECriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__(size_average)
        self.weights = _weights(weights)

    def apply_loss(self, x, target):
        xc = torch.clamp(x, 1e-12, 1 - 1e-12)
        loss = -(target * torch.log(xc) + (1 - target) * torch.log(1 - xc))
        if self.weights is not None:
            loss = loss * self.weights.to(x.device)
        return _reduce(loss, self.size_average)


class BCEWithLogitsCriterion(Criterion):
    def apply_loss(self, x, target):
        loss = torch.clamp(x, min=0) - x * target \
            + torch.log1p(torch.exp(-torch.abs(x)))
        return _reduce(loss, self.size_average)


class DistKLDivCriterion(Criterion):
    """KL divergence, input = log-probs (ref: nn/DistKLDivCriterion.scala)."""

    def apply_loss(self, x, target):
        loss = torch.where(target > 0,
                           target * (torch.log(target + 1e-12) - x),
                           torch.zeros_like(x))
        return loss.sum() / x.shape[0] if self.size_average else loss.sum()


class MarginCriterion(Criterion):
    """Hinge loss, targets ±1 (ref: nn/MarginCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        super().__init__(size_average)
        self.margin = margin
        self.squared = squared

    def apply_loss(self, x, target):
        loss = torch.clamp(self.margin - x * target, min=0.0)
        return _reduce(loss * loss if self.squared else loss,
                       self.size_average)


class MarginRankingCriterion(Criterion):
    """ref: nn/MarginRankingCriterion.scala — input Table(x1, x2)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def apply_loss(self, x, target):
        x1, x2 = list(x)
        return _reduce(torch.clamp(-target * (x1 - x2) + self.margin,
                                   min=0.0), self.size_average)


class HingeEmbeddingCriterion(Criterion):
    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def apply_loss(self, x, target):
        loss = torch.where(target > 0, x,
                           torch.clamp(self.margin - x, min=0.0))
        return _reduce(loss, self.size_average)


def _cos(a, b):
    return (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                              * torch.linalg.vector_norm(b, dim=-1) + 1e-12)


class CosineEmbeddingCriterion(Criterion):
    """ref: nn/CosineEmbeddingCriterion.scala — input Table(x1, x2)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def apply_loss(self, x, target):
        cos = _cos(*list(x))
        t = target.reshape(cos.shape)
        loss = torch.where(t > 0, 1.0 - cos,
                           torch.clamp(cos - self.margin, min=0.0))
        return _reduce(loss, self.size_average)


class SoftmaxWithCriterion(Criterion):
    """Softmax + NLL on raw scores with NCHW support (ref: caffe-style)."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__(True)
        self.ignore_label = ignore_label

    def apply_loss(self, x, target):
        logp = torch.log_softmax(x, dim=1)
        idx = target.to(torch.int64) - 1
        picked = logp.gather(1, idx[:, None])
        valid = torch.ones_like(picked, dtype=torch.bool) \
            if self.ignore_label is None \
            else idx[:, None] != self.ignore_label - 1
        return -torch.where(valid, picked, torch.zeros_like(picked)).sum() \
            / torch.clamp(valid.sum(), min=1)


class ParallelCriterion(Criterion):
    """Weighted sum of criterions over Table inputs (ref: ParallelCriterion.scala)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__(True)
        self.repeat_target = repeat_target
        self.criterions: list = []
        self.weights: list = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def apply_loss(self, x, target):
        xs = list(x) if isinstance(x, (Table, list, tuple)) else [x]
        if self.repeat_target or not isinstance(target,
                                                (Table, list, tuple)):
            ts = [target] * len(xs)
        else:
            ts = list(target)
        total = 0.0
        for crit, w, xi, ti in zip(self.criterions, self.weights, xs, ts):
            total = total + w * crit.apply_loss(xi, ti)
        return total


class TimeDistributedCriterion(Criterion):
    """Apply a criterion at every timestep (ref: TimeDistributedCriterion.scala)."""

    def __init__(self, criterion: Criterion, size_average: bool = True,
                 dimension: int = 2):
        super().__init__(size_average)
        self.criterion = criterion
        self.dimension = dimension

    def apply_loss(self, x, target):
        d = self.dimension - 1
        steps = x.shape[d]
        total = 0.0
        for t in range(steps):
            tt = target.select(d, t) if target.dim() >= self.dimension \
                else target
            total = total + self.criterion.apply_loss(x.select(d, t), tt)
        return total / steps if self.size_average else total


class MultiCriterion(Criterion):
    """Sum of criterions on the same input (ref: nn/MultiCriterion.scala)."""

    def __init__(self):
        super().__init__(True)
        self.criterions: list = []
        self.weights: list = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def apply_loss(self, x, target):
        total = 0.0
        for crit, w in zip(self.criterions, self.weights):
            total = total + w * crit.apply_loss(x, target)
        return total


class MultiLabelSoftMarginCriterion(Criterion):
    def apply_loss(self, x, target):
        loss = -(target * F.logsigmoid(x) + (1 - target) * F.logsigmoid(-x))
        return _reduce(loss, self.size_average)


class SoftMarginCriterion(Criterion):
    def apply_loss(self, x, target):
        return _reduce(torch.log1p(torch.exp(-x * target)),
                       self.size_average)


class MultiMarginCriterion(Criterion):
    """Multi-class hinge (ref: nn/MultiMarginCriterion.scala); 1-based target."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__(size_average)
        self.p, self.margin = p, margin

    def apply_loss(self, x, target):
        idx = _class_index(target, False).to(x.device)
        correct = x.gather(1, idx[:, None])
        loss = torch.clamp(self.margin - correct + x, min=0.0) ** self.p
        mask = F.one_hot(idx, x.shape[1]).bool()
        loss = torch.where(mask, torch.zeros_like(loss), loss)
        return _reduce(loss.sum(1) / x.shape[1], self.size_average)


class MAECriterion(AbsCriterion):
    pass


class KullbackLeiblerDivergenceCriterion(Criterion):
    """Keras-style KLD over probability inputs."""

    def apply_loss(self, x, target):
        t = torch.clamp(target, 1e-7, 1.0)
        p = torch.clamp(x, 1e-7, 1.0)
        return (t * torch.log(t / p)).sum(-1).mean()


class PoissonCriterion(Criterion):
    def apply_loss(self, x, target):
        return (x - target * torch.log(x + 1e-7)).mean()


class CosineProximityCriterion(Criterion):
    def apply_loss(self, x, target):
        xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        tn = target / (torch.linalg.vector_norm(target, dim=-1,
                                                keepdim=True) + 1e-12)
        return -(xn * tn).sum(-1).mean()


class MeanAbsolutePercentageCriterion(Criterion):
    def apply_loss(self, x, target):
        diff = torch.abs((target - x) / torch.clamp(torch.abs(target),
                                                    min=1e-7))
        return 100.0 * diff.mean()


class MeanSquaredLogarithmicCriterion(Criterion):
    def apply_loss(self, x, target):
        a = torch.log(torch.clamp(x, min=1e-7) + 1.0)
        b = torch.log(torch.clamp(target, min=1e-7) + 1.0)
        return ((a - b) ** 2).mean()


class CosineDistanceCriterion(Criterion):
    """1 - cos(x, target) (ref: nn/CosineDistanceCriterion.scala)."""

    def apply_loss(self, x, target):
        return _reduce(1.0 - _cos(x, target), self.size_average)


class DiceCoefficientCriterion(Criterion):
    """1 - Dice overlap, the segmentation loss
    (ref: nn/DiceCoefficientCriterion.scala)."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__(size_average)
        self.epsilon = epsilon

    def apply_loss(self, x, target):
        xf = x.reshape(x.shape[0], -1)
        tf_ = target.reshape(x.shape[0], -1).to(xf.dtype)
        dice = (2.0 * (xf * tf_).sum(1) + self.epsilon) / (
            xf.sum(1) + tf_.sum(1) + self.epsilon)
        return _reduce(1.0 - dice, self.size_average)


class KLDCriterion(Criterion):
    """KL(N(mean, exp(log_var)) || N(0, 1)) on a Table(mean, log_var)
    (ref: nn/KLDCriterion.scala); ``target`` is ignored."""

    def apply_loss(self, x, target=None):
        mean, log_var = list(x)
        kl = -0.5 * (1.0 + log_var - mean * mean - torch.exp(log_var)).sum(-1)
        return _reduce(kl, self.size_average)


class GaussianCriterion(Criterion):
    """Negative log-likelihood of ``target`` under the diagonal gaussian
    Table(mean, log_var) (ref: nn/GaussianCriterion.scala)."""

    def apply_loss(self, x, target):
        mean, log_var = list(x)
        nll = 0.5 * (math.log(2.0 * math.pi) + log_var
                     + (target - mean) ** 2 / torch.exp(log_var))
        return _reduce(nll.sum(-1), self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """Table(x1, x2) with label y=1 (similar) / -1: ||x1-x2||_1 or
    max(0, margin - ||x1-x2||_1) (ref: nn/L1HingeEmbeddingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__(size_average)
        self.margin = margin

    def apply_loss(self, x, target):
        x1, x2 = list(x)
        a = torch.abs(x1 - x2)
        d = a.sum(tuple(range(1, x1.dim()))) if x1.dim() > 1 else a.sum()
        t = target.reshape(d.shape)
        loss = torch.where(t > 0, d, torch.clamp(self.margin - d, min=0.0))
        return _reduce(loss, self.size_average)


class MultiLabelMarginCriterion(Criterion):
    """torch-semantics multi-label margin (ref:
    nn/MultiLabelMarginCriterion.scala): target rows hold 1-based class
    indices, 0-padded, and a row's list ends at its first 0; loss = sum
    over (target j, non-target i) of max(0, 1 - (x[j] - x[i])) / C."""

    def apply_loss(self, x, target):
        x2 = x if x.dim() == 2 else x[None]
        t2 = target.to(torch.int64)
        t2 = t2 if t2.dim() == 2 else t2[None]
        c = x2.shape[1]
        valid = torch.cumprod((t2 > 0).to(torch.int64), dim=1) > 0
        idx = torch.clamp(t2 - 1, 0, c - 1)
        is_target = (F.one_hot(idx, c).bool() & valid[..., None]).any(1)
        xt = torch.where(valid, x2.gather(1, idx), torch.zeros_like(x2))
        m = 1.0 - (xt[:, :, None] - x2[:, None, :])
        ok = valid[:, :, None] & ~is_target[:, None, :]
        loss = torch.where(ok, torch.clamp(m, min=0.0),
                           torch.zeros_like(m)).sum((1, 2)) / c
        return _reduce(loss, self.size_average)


class ClassSimplexCriterion(Criterion):
    """MSE against the regular-simplex embedding of the class label
    (ref: nn/ClassSimplexCriterion.scala)."""

    def __init__(self, n_classes: int, size_average: bool = True):
        super().__init__(size_average)
        if n_classes < 2:
            raise ValueError("n_classes must be >= 2")
        self.n_classes = n_classes
        a = np.eye(n_classes, dtype=np.float64) - 1.0 / n_classes
        a = a / np.linalg.norm(a, axis=1, keepdims=True)
        self._targets = torch.as_tensor(a, dtype=torch.float32)

    def apply_loss(self, x, target):
        idx = torch.clamp(target.to(torch.int64) - 1, 0,
                          self.n_classes - 1).reshape(-1)
        goal = self._targets.to(x.device)[idx.to(x.device)]
        return _reduce((x.reshape(goal.shape) - goal) ** 2,
                       self.size_average)


class TimeDistributedMaskCriterion(Criterion):
    """TimeDistributedCriterion with a per-timestep mask
    (ref: nn/TimeDistributedMaskCriterion.scala): target is Table(labels
    (B, T), mask (B, T)); masked steps contribute 0. Each sample's loss
    is the criterion on a batch of one."""

    def __init__(self, criterion: Criterion, size_average: bool = True):
        super().__init__(size_average)
        self.criterion = criterion

    def apply_loss(self, x, target):
        labels, mask = list(target)
        total = count = 0.0
        for t in range(x.shape[1]):
            xt, lt = x[:, t], labels[:, t]
            mt = mask[:, t].to(torch.float32)
            per = torch.stack([self.criterion.apply_loss(xt[i:i + 1],
                                                         lt[i:i + 1])
                               for i in range(x.shape[0])])
            total = total + (per * mt).sum()
            count = count + mt.sum()
        return total / torch.clamp(torch.as_tensor(count), min=1e-12) \
            if self.size_average else total

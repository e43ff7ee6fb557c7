"""ValidationMethods — the port of ``bigdl_tpu/optim/validation.py`` (ref: .../optim/ValidationMethod.scala — Top1Accuracy,
Top5Accuracy, Loss, MAE, HitRatio, NDCG, TreeNNAccuracy) and their result
type (ref: ValidationResult/AccuracyResult).

Each method maps (output, target) minibatch arrays → a mergeable
ValidationResult; the Evaluator/Optimizer folds results across batches
(and, distributed, across hosts).
"""

from __future__ import annotations


import numpy as np
import torch

from bigdl_tpu_torch.nn.module import to_numpy


class ValidationResult:
    def __init__(self, sum_value: float, count: int, fmt: str = "{:.6f}"):
        self.sum_value = float(sum_value)
        self.count = int(count)
        self.fmt = fmt

    @property
    def result(self) -> float:
        return self.sum_value / max(self.count, 1)

    def merge(self, other: "ValidationResult") -> "ValidationResult":
        return ValidationResult(self.sum_value + other.sum_value,
                                self.count + other.count, self.fmt)

    # BigDL prints e.g. "Accuracy(correct: 123, count: 200, accuracy: 0.615)"
    def __repr__(self):
        return f"{self.fmt.format(self.result)} (sum {self.sum_value:.4f}, count {self.count})"


class ValidationMethod:
    name = "ValidationMethod"

    def __call__(self, output, target) -> ValidationResult:
        return self.apply(to_numpy(output), to_numpy(target))

    def apply(self, output: np.ndarray, target: np.ndarray) -> ValidationResult:
        raise NotImplementedError

    def __repr__(self):
        return self.name


def _class_target(target: np.ndarray, zero_based: bool) -> np.ndarray:
    t = target.astype(np.int64)
    if t.ndim > 1:
        t = t.reshape(t.shape[0])
    return t if zero_based else t - 1


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"

    def __init__(self, zero_based_label: bool = False):
        self.zero_based = zero_based_label

    def apply(self, output, target):
        pred = output.argmax(axis=-1)
        t = _class_target(target, self.zero_based)
        return ValidationResult(float((pred == t).sum()), t.shape[0])


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def __init__(self, zero_based_label: bool = False):
        self.zero_based = zero_based_label

    def apply(self, output, target):
        top5 = np.argsort(-output, axis=-1)[:, :5]
        t = _class_target(target, self.zero_based)
        correct = (top5 == t[:, None]).any(axis=1).sum()
        return ValidationResult(float(correct), t.shape[0])


class Loss(ValidationMethod):
    name = "Loss"

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
        self.criterion = criterion or ClassNLLCriterion()

    def apply(self, output, target):
        loss = float(self.criterion.apply_loss(torch.from_numpy(output),
                                               torch.from_numpy(target)))
        n = output.shape[0]
        return ValidationResult(loss * n, n)


class MAE(ValidationMethod):
    name = "MAE"

    def apply(self, output, target):
        n = output.shape[0]
        return ValidationResult(
            float(np.abs(output - target).mean()) * n, n)


class HitRatio(ValidationMethod):
    """HR@k for recommendation (ref: optim/ValidationMethod.scala HitRatio).

    Expects output = score matrix (batch, candidates), target: the positive
    item is column 0 by reference convention (positive first).
    """

    name = "HitRatio"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k

    def apply(self, output, target):
        # rank of item 0 among candidates
        rank = (output > output[:, :1]).sum(axis=1)
        hits = (rank < self.k).sum()
        return ValidationResult(float(hits), output.shape[0])


class NDCG(ValidationMethod):
    name = "NDCG"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k

    def apply(self, output, target):
        rank = (output > output[:, :1]).sum(axis=1)
        gains = np.where(rank < self.k, 1.0 / np.log2(rank + 2.0), 0.0)
        return ValidationResult(float(gains.sum()), output.shape[0])

"""The port's ``optim`` (``bigdl_tpu/optim``): the optim methods and
schedules, triggers, validation methods, summaries, metrics and the
optimizers (``LocalOptimizer``; ``DistriOptimizer``, data-parallel over
the Engine's mesh; the ``Optimizer`` facade)."""

from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import (
    LBFGS, Adadelta, Adagrad, Adam, Adamax, AdamWeightDecay, Default,
    Exponential, Ftrl, LearningRateSchedule, MultiStep, OptimMethod,
    ParallelAdam, Plateau, Poly, RMSprop, SequentialSchedule, SGD, Step,
    Warmup)
from bigdl_tpu_torch.optim.optimizer import (
    BaseOptimizer, DistriOptimizer, Evaluator, LocalOptimizer, Optimizer,
    Predictor, validate)
from bigdl_tpu_torch.optim.summary import TrainSummary, ValidationSummary
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (
    HitRatio, Loss, MAE, NDCG, Top1Accuracy, Top5Accuracy, ValidationMethod,
    ValidationResult)

__all__ = [
    "Adadelta", "Adagrad", "Adam", "Adamax", "AdamWeightDecay",
    "BaseOptimizer", "Default", "DistriOptimizer", "Evaluator",
    "Exponential", "Ftrl", "HitRatio", "LBFGS", "LearningRateSchedule",
    "LocalOptimizer", "Loss", "MAE", "Metrics", "MultiStep", "NDCG",
    "OptimMethod", "Optimizer", "ParallelAdam", "Plateau", "Poly",
    "Predictor", "RMSprop", "SGD", "SequentialSchedule", "Step",
    "Top1Accuracy", "Top5Accuracy", "TrainSummary", "Trigger",
    "ValidationMethod", "ValidationResult", "ValidationSummary", "Warmup",
    "validate"]

"""DLlib ``nn`` of the port (``bigdl_tpu/nn``): the module contract and
``Criterion``, the initialisers, the containers, the layers (linear,
conv, pooling, normalization, activation, dropout, shape, embedding,
attention, misc, recurrent, volumetric, extra2, extra3), the criterions,
and ``nn.quantized`` (import it as ``bigdl_tpu_torch.nn.quantized``).
``CosineDistance``, ``DotProduct``, ``MM`` and ``MV`` are
``nn/layers/misc.py``'s, as in the JAX ``nn``; the DAG container is
``bigdl_tpu_torch.nn.graph`` (``Graph``, ``Input``, ``Module.inputs``),
which this module does not re-export, as the JAX ``nn`` does not."""

from bigdl_tpu_torch.nn.module import (Criterion, Module, TensorModule,
                                       set_seed)
from bigdl_tpu_torch.nn.initialization import (
    ConstInitMethod, InitializationMethod, MsraFiller, Ones, RandomNormal,
    RandomUniform, Xavier, Zeros)
from bigdl_tpu_torch.nn.containers import (
    Bottle, CAddTable, CAveTable, CDivTable, CMaxTable, CMinTable, CMulTable,
    CSubTable, Checkpoint, Concat, ConcatTable, Container, Echo,
    FlattenTable, JoinTable, MapTable, ParallelTable, SelectTable,
    Sequential, SplitTable)
from bigdl_tpu_torch.nn.layers import *  # noqa: F401,F403
from bigdl_tpu_torch.nn.layers import __all__ as _layers
from bigdl_tpu_torch.nn.criterion import (
    AbsCriterion, BCECriterion, BCEWithLogitsCriterion,
    CategoricalCrossEntropy, ClassNLLCriterion, ClassSimplexCriterion,
    CosineDistanceCriterion, CosineEmbeddingCriterion,
    CosineProximityCriterion, CrossEntropyCriterion,
    DiceCoefficientCriterion, DistKLDivCriterion, GaussianCriterion,
    HingeEmbeddingCriterion, KLDCriterion,
    KullbackLeiblerDivergenceCriterion, L1Cost, L1HingeEmbeddingCriterion,
    MAECriterion, MarginCriterion, MarginRankingCriterion,
    MeanAbsolutePercentageCriterion, MeanSquaredLogarithmicCriterion,
    MSECriterion, MultiCriterion, MultiLabelMarginCriterion,
    MultiLabelSoftMarginCriterion, MultiMarginCriterion, ParallelCriterion,
    PoissonCriterion, SmoothL1Criterion, SoftMarginCriterion,
    SoftmaxWithCriterion, TimeDistributedCriterion,
    TimeDistributedMaskCriterion)

__all__ = list(_layers) + [
    "AbsCriterion", "BCECriterion", "BCEWithLogitsCriterion", "Bottle",
    "CAddTable", "CAveTable", "CDivTable", "CMaxTable", "CMinTable",
    "CMulTable", "CSubTable", "CategoricalCrossEntropy", "Checkpoint",
    "ClassNLLCriterion", "ClassSimplexCriterion", "Concat", "ConcatTable",
    "ConstInitMethod", "Container", "CosineDistanceCriterion",
    "CosineEmbeddingCriterion", "CosineProximityCriterion", "Criterion",
    "CrossEntropyCriterion", "DiceCoefficientCriterion", "DistKLDivCriterion",
    "Echo", "FlattenTable", "GaussianCriterion", "HingeEmbeddingCriterion",
    "InitializationMethod", "JoinTable", "KLDCriterion",
    "KullbackLeiblerDivergenceCriterion", "L1Cost",
    "L1HingeEmbeddingCriterion", "MAECriterion", "MSECriterion", "MapTable",
    "MarginCriterion", "MarginRankingCriterion",
    "MeanAbsolutePercentageCriterion", "MeanSquaredLogarithmicCriterion",
    "Module", "MsraFiller", "MultiCriterion", "MultiLabelMarginCriterion",
    "MultiLabelSoftMarginCriterion", "MultiMarginCriterion", "Ones",
    "ParallelCriterion", "ParallelTable", "PoissonCriterion", "RandomNormal",
    "RandomUniform", "SelectTable", "Sequential", "SmoothL1Criterion",
    "SoftMarginCriterion", "SoftmaxWithCriterion", "SplitTable",
    "TensorModule", "TimeDistributedCriterion", "TimeDistributedMaskCriterion",
    "Xavier", "Zeros", "set_seed"]

"""The port's ``feature`` (``bigdl_tpu/feature``): the dataset layer,
the sample transformers, the MNIST, CIFAR and ImageNet readers, and the
vision pipeline (``bigdl_tpu_torch.feature.vision``)."""

from bigdl_tpu_torch.feature.dataset import (
    DataSet, DistributedDataSet, LocalDataSet, MiniBatch, PrefetchDataSet,
    Sample, SampleToMiniBatch)
from bigdl_tpu_torch.feature.transformers import (
    ChainedTransformer, Normalizer, OneHot, Transformer)
from bigdl_tpu_torch.feature import cifar, imagenet

__all__ = [
    "DataSet", "DistributedDataSet", "LocalDataSet", "MiniBatch",
    "PrefetchDataSet", "Sample", "SampleToMiniBatch", "Transformer",
    "ChainedTransformer", "Normalizer", "OneHot", "cifar", "imagenet",
]

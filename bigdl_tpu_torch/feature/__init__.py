"""The port's ``feature`` (``bigdl_tpu/feature``): the dataset layer and
the MNIST loader."""

from bigdl_tpu_torch.feature.dataset import (
    DataSet, DistributedDataSet, LocalDataSet, MiniBatch, PrefetchDataSet,
    Sample, SampleToMiniBatch)

__all__ = ["DataSet", "DistributedDataSet", "LocalDataSet", "MiniBatch",
           "PrefetchDataSet", "Sample", "SampleToMiniBatch"]

"""bigdl_tpu_torch.nnframes — the port of ``bigdl_tpu/nnframes``,
DataFrame ML pipeline integration (ref: S:dllib/nnframes +
P:dllib/nnframes: Spark-ML Estimator/Transformer wrappers
NNEstimator/NNModel/NNClassifier/NNImageReader).

The Spark DataFrame substrate maps to pandas, as in the JAX package; the
fit/transform contract and the column conventions
(featuresCol/labelCol/predictionCol) are the reference's."""

from bigdl_tpu_torch.nnframes.nn_estimator import (
    NNClassifier, NNClassifierModel, NNEstimator, NNImageReader, NNModel)

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader"]

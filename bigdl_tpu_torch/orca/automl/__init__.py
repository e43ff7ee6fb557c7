"""orca.automl of the port (``bigdl_tpu/orca/automl``): the search-space
samplers and :class:`AutoEstimator`."""

from bigdl_tpu_torch.orca.automl.auto_estimator import AutoEstimator
from bigdl_tpu_torch.orca.automl.hp import hp

__all__ = ["AutoEstimator", "hp"]

"""nano of the port (``bigdl_tpu/nano``): :class:`InferenceOptimizer`
and :class:`Trainer`."""

from bigdl_tpu_torch.nano.inference_optimizer import InferenceOptimizer
from bigdl_tpu_torch.nano.trainer import Trainer

__all__ = ["InferenceOptimizer", "Trainer"]

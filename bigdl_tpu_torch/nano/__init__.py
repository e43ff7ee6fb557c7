"""nano of the port (``bigdl_tpu/nano``): :class:`InferenceOptimizer`."""

from bigdl_tpu_torch.nano.inference_optimizer import InferenceOptimizer

__all__ = ["InferenceOptimizer"]

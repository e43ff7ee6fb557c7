from bigdl_tpu_torch.orca.learn.estimator import Estimator

__all__ = ["Estimator"]

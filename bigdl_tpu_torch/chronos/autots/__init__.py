from bigdl_tpu_torch.chronos.autots.auto_ts import AutoTSEstimator, TSPipeline

__all__ = ["AutoTSEstimator", "TSPipeline"]

from bigdl_tpu_torch.chronos.data.tsdataset import TSDataset, roll_windows

__all__ = ["TSDataset", "roll_windows"]

"""bigdl_tpu_torch.chronos — the port of ``bigdl_tpu/chronos``, the
time-series toolkit (ref: python/chronos — TSDataset, forecasters,
detectors; BASELINE config 3 = TCN/Seq2Seq), on the port's DLlib ``nn``
and ``optim``. Its entry points take ``device=None``, which means the
GPU (:func:`~bigdl_tpu_torch.device.resolve_device`)."""

from bigdl_tpu_torch.chronos.data import TSDataset
from bigdl_tpu_torch.chronos.forecaster import (
    LSTMForecaster, NBeatsForecaster, Seq2SeqForecaster, TCNForecaster)
from bigdl_tpu_torch.chronos.detector import AEDetector, ThresholdDetector

__all__ = ["TSDataset", "TCNForecaster", "Seq2SeqForecaster",
           "LSTMForecaster", "NBeatsForecaster", "ThresholdDetector",
           "AEDetector"]

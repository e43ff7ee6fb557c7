from bigdl_tpu_torch.chronos.forecaster.base import BaseForecaster
from bigdl_tpu_torch.chronos.forecaster.tcn import TCNForecaster
from bigdl_tpu_torch.chronos.forecaster.seq2seq import Seq2SeqForecaster
from bigdl_tpu_torch.chronos.forecaster.lstm import LSTMForecaster
from bigdl_tpu_torch.chronos.forecaster.nbeats import NBeatsForecaster
from bigdl_tpu_torch.chronos.forecaster.autoformer import AutoformerForecaster

__all__ = ["BaseForecaster", "TCNForecaster", "Seq2SeqForecaster",
           "LSTMForecaster", "NBeatsForecaster", "AutoformerForecaster"]

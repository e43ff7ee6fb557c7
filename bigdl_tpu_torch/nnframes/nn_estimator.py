"""NNEstimator / NNModel — the port of ``bigdl_tpu/nnframes/nn_estimator.py``
(ref: S:dllib/nnframes/NNEstimator.scala — a Spark ML Estimator: fit(df)
trains the wrapped module via Optimizer and returns an NNModel
Transformer whose transform(df) appends predictions).

The frames are pandas (imported by the callers that build them: this
module needs only their columns). Training goes through the port's
``Optimizer`` facade and prediction through its ``Predictor``, on
``device`` (``None``: the GPU); ``NNImageReader`` decodes through the
port's ``feature.vision``."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger


def _col_to_array(df, col: str) -> np.ndarray:
    vals = df[col].to_numpy()
    if len(vals) and isinstance(vals[0], (list, tuple, np.ndarray)):
        return np.stack([np.asarray(v, np.float32) for v in vals])
    return vals.astype(np.float32)[:, None]


class NNEstimator:
    """ref ctor: NNEstimator(model, criterion, featureSize, labelSize)."""

    def __init__(self, model: Module, criterion: Criterion,
                 feature_size: Optional[Sequence[int]] = None,
                 label_size: Optional[Sequence[int]] = None,
                 device=None):
        self.model = model
        self.criterion = criterion
        self.feature_size = feature_size
        self.label_size = label_size
        self.features_col = "features"
        self.label_col = "label"
        self.prediction_col = "prediction"
        self.batch_size = 32
        self.max_epoch = 10
        self.optim_method: Optional[OptimMethod] = None
        self.learning_rate = None
        self.device = device

    # -- param setters (Spark ML naming) -------------------------------------
    def set_features_col(self, name: str):
        self.features_col = name
        return self

    def set_label_col(self, name: str):
        self.label_col = name
        return self

    def set_prediction_col(self, name: str):
        self.prediction_col = name
        return self

    def set_batch_size(self, n: int):
        self.batch_size = n
        return self

    def set_max_epoch(self, n: int):
        self.max_epoch = n
        return self

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    def set_learning_rate(self, lr: float):
        self.learning_rate = lr
        return self

    # -- Estimator contract ---------------------------------------------------
    def fit(self, df) -> "NNModel":
        from bigdl_tpu_torch.optim.optimizer import Optimizer

        x = _col_to_array(df, self.features_col)
        if self.feature_size:
            x = x.reshape((-1,) + tuple(self.feature_size))
        y = df[self.label_col].to_numpy()
        if len(y) and isinstance(y[0], (list, tuple, np.ndarray)):
            y = np.stack([np.asarray(v, np.float32) for v in y])
        opt = Optimizer(self.model, (x, np.asarray(y)), self.criterion,
                        batch_size=self.batch_size,
                        end_trigger=Trigger.max_epoch(self.max_epoch),
                        device=self.device)
        if self.optim_method is not None:
            if self.learning_rate is not None:
                self.optim_method.learning_rate = self.learning_rate
            opt.set_optim_method(self.optim_method)
        elif self.learning_rate is not None:
            from bigdl_tpu_torch.optim.optim_method import SGD
            opt.set_optim_method(SGD(learning_rate=self.learning_rate))
        opt.optimize()
        return self._make_model()

    def _make_model(self) -> "NNModel":
        m = NNModel(self.model, self.feature_size, self.device)
        m.features_col = self.features_col
        m.prediction_col = self.prediction_col
        m.batch_size = self.batch_size
        return m


class NNModel:
    """ref: NNModel — Spark ML Transformer appending predictions."""

    def __init__(self, model: Module,
                 feature_size: Optional[Sequence[int]] = None,
                 device=None):
        self.model = model
        self.feature_size = feature_size
        self.device = device
        self.features_col = "features"
        self.prediction_col = "prediction"
        self.batch_size = 32

    def transform(self, df):
        from bigdl_tpu_torch.optim.optimizer import Predictor

        x = _col_to_array(df, self.features_col)
        if self.feature_size:
            x = x.reshape((-1,) + tuple(self.feature_size))
        pred = Predictor(self.model, self.batch_size,
                         self.device).predict(x)
        out = df.copy()
        out[self.prediction_col] = [np.asarray(p) for p in pred]
        return out

    def save(self, path: str):
        self.model.save_module(path)
        return self

    @staticmethod
    def load(path: str, device=None) -> "NNModel":
        return NNModel(Module.load_module(path, device), device=device)


class NNClassifier(NNEstimator):
    """ref: NNClassifier — label is a scalar class; prediction is the
    argmax class (1-based, Spark ML double)."""

    def fit(self, df) -> "NNClassifierModel":
        nn_model = super().fit(df)
        m = NNClassifierModel(self.model, self.feature_size, self.device)
        m.features_col = nn_model.features_col
        m.prediction_col = nn_model.prediction_col
        m.batch_size = nn_model.batch_size
        return m


class NNClassifierModel(NNModel):
    def transform(self, df):
        from bigdl_tpu_torch.optim.optimizer import Predictor

        x = _col_to_array(df, self.features_col)
        if self.feature_size:
            x = x.reshape((-1,) + tuple(self.feature_size))
        pred = Predictor(self.model, self.batch_size,
                         self.device).predict(x)
        out = df.copy()
        out[self.prediction_col] = (pred.argmax(axis=-1) + 1).astype(float)
        return out


class NNImageReader:
    """ref: NNImageReader.readImages — images into a DataFrame with an
    image-struct column; here: a pandas frame of decoded HWC arrays."""

    @staticmethod
    def read_images(path: str, min_partitions: int = 1):
        import pandas as pd

        from bigdl_tpu_torch.feature.vision import (
            ImageFrame, ImageFeature, PixelBytesToMat)

        frame = ImageFrame.read(path).transform(PixelBytesToMat())
        rows = [{"image": f[ImageFeature.MAT],
                 "origin": f.get(ImageFeature.URI)}
                for f in frame.features]
        return pd.DataFrame(rows)

"""Orca Estimators — the port of ``bigdl_tpu/orca/learn/estimator.py``
(ref: P:orca/learn/*/estimator.py — one Estimator per backend: bigdl,
torch_distributed/spark, tf2).

- ``Estimator.from_bigdl`` — the port's nn / Keras model through the
  ``Optimizer`` facade: ``DistriOptimizer`` over the Engine's mesh when
  ``distributed`` (default: an initialised Engine with a world above
  one), else ``LocalOptimizer``; XShards are merged and fed to the
  ``data`` axis.
- ``Estimator.from_torch`` — a ``torch.nn.Module`` and ``torch.optim``
  loop from creator functions (TorchRunner's API), driven shard by
  shard; the JAX package's loop runs it on the host, the port on
  ``device``.
- ``Estimator.from_keras`` (backend ``"tf2"``) — a creator-built
  tf.keras model trained with an explicit ``tf.GradientTape`` loop on
  the host; ``tensorflow`` is imported only by this backend.

Every entry takes ``device=None``, which means the GPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from bigdl_tpu_torch.orca.data import XShards


def _xy_from_data(data, label_cols=None, feature_cols=None):
    if isinstance(data, dict) and "x" in data and "y" in data:
        return data["x"], data["y"]
    if isinstance(data, XShards):
        merged = data.merged()
        if isinstance(merged, dict):
            if "x" in merged and "y" in merged:
                return merged["x"], merged["y"]
            if feature_cols and label_cols:
                x = np.stack([merged[c] for c in feature_cols], axis=-1)
                y = np.stack([merged[c] for c in label_cols], axis=-1)
                return x, y
            raise ValueError("dict shards need x/y keys or feature/label "
                             "cols")
        return merged
    return data


def _features(data):
    if isinstance(data, XShards):
        merged = data.merged()
        return merged["x"] if isinstance(merged, dict) else merged
    return data


class BigDLEstimator:
    def __init__(self, model, loss, optimizer, metrics, device=None,
                 distributed: Optional[bool] = None):
        from bigdl_tpu_torch.device import resolve_device
        from bigdl_tpu_torch.keras.metrics import to_validation_methods
        from bigdl_tpu_torch.keras.objectives import to_criterion
        from bigdl_tpu_torch.keras.optimizers import to_optim_method

        # keras-API models carry their own module
        self.model = getattr(model, "module", model)
        self.criterion = to_criterion(loss) if loss is not None else None
        self.optim_method = to_optim_method(optimizer) \
            if optimizer is not None else None
        self.metrics = to_validation_methods(metrics or [])
        self.device = resolve_device(device)
        self.distributed = distributed
        #: the optimizer of the last ``fit`` (its state, metrics, loss)
        self.optimizer = None

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols=None, label_cols=None, validation_data=None):
        from bigdl_tpu_torch.optim.optimizer import Optimizer
        from bigdl_tpu_torch.optim.trigger import Trigger

        x, y = _xy_from_data(data, label_cols, feature_cols)
        opt = Optimizer(self.model, (np.asarray(x), np.asarray(y)),
                        self.criterion, batch_size=batch_size,
                        end_trigger=Trigger.max_epoch(epochs),
                        distributed=self.distributed, device=self.device)
        if self.optim_method is not None:
            opt.set_optim_method(self.optim_method)
        if validation_data is not None and self.metrics:
            vx, vy = _xy_from_data(validation_data, label_cols,
                                   feature_cols)
            opt.set_validation(Trigger.every_epoch(),
                               (np.asarray(vx), np.asarray(vy)),
                               self.metrics, batch_size)
        self.optimizer = opt
        opt.optimize()
        return self

    def predict(self, data, batch_size: int = 128, feature_cols=None):
        from bigdl_tpu_torch.optim.optimizer import Predictor
        return Predictor(self.model, batch_size, device=self.device) \
            .predict(np.asarray(_features(data)))

    def evaluate(self, data, batch_size: int = 128, feature_cols=None,
                 label_cols=None):
        from bigdl_tpu_torch.optim.optimizer import Evaluator

        x, y = _xy_from_data(data, label_cols, feature_cols)
        return Evaluator(self.model, device=self.device).evaluate(
            (np.asarray(x), np.asarray(y)), self.metrics, batch_size)

    def get_model(self):
        return self.model

    def save(self, path: str):
        self.model.save_module(path)
        return self

    def load(self, path: str):
        from bigdl_tpu_torch.nn.module import Module

        self.model = Module.load_module(path, device=self.device)
        return self


class TorchEstimator:
    """ref: P:orca/learn/pytorch — creator-function API; the training loop
    is torch's own (TorchRunner.train_epochs), driven shard by shard on
    ``device``: each batch is copied there, the loss of each shard's last
    batch is read back."""

    def __init__(self, model_creator: Callable,
                 optimizer_creator: Callable, loss_creator: Callable,
                 config: Optional[dict] = None, device=None):
        from bigdl_tpu_torch.device import resolve_device

        self.config = config or {}
        self.device = resolve_device(device)
        self.model = model_creator(self.config).to(self.device)
        self.optimizer = optimizer_creator(self.model, self.config)
        loss = loss_creator(self.config) if loss_creator else None
        self.loss_fn = loss

    def _batch(self, a):
        import torch
        t = torch.as_tensor(np.asarray(a))
        return t.to(self.device, non_blocking=True)

    def fit(self, data, epochs: int = 1, batch_size: int = 32):
        self.model.train()
        stats = []
        for _ in range(epochs):
            shards = data.collect() if isinstance(data, XShards) else [data]
            for shard in shards:
                if isinstance(shard, dict):
                    x, y = shard["x"], shard["y"]
                else:
                    x, y = shard
                n = len(x)
                for i in range(0, n, batch_size):
                    xb = self._batch(x[i:i + batch_size])
                    yb = self._batch(y[i:i + batch_size])
                    self.optimizer.zero_grad()
                    out = self.model(xb)
                    if hasattr(out, "logits"):   # HF-style outputs
                        out = out.logits
                    loss = self.loss_fn(out, yb)
                    loss.backward()
                    self.optimizer.step()
                stats.append(float(loss.detach()))
        return stats

    def predict(self, data, batch_size: int = 128) -> np.ndarray:
        import torch
        self.model.eval()
        x = _features(data)
        outs = []
        with torch.no_grad():
            for i in range(0, len(x), batch_size):
                out = self.model(self._batch(x[i:i + batch_size]))
                if hasattr(out, "logits"):
                    out = out.logits
                outs.append(out.float().cpu().numpy())
        return np.concatenate(outs, 0)

    def evaluate(self, data, batch_size: int = 128) -> dict:
        x, y = _xy_from_data(data)
        pred = self.predict(x, batch_size)
        if pred.ndim > 1 and pred.shape[-1] > 1:
            acc = float((pred.argmax(-1) == np.asarray(y)).mean())
            return {"Accuracy": acc}
        diff = pred.squeeze() - np.asarray(y).squeeze()
        return {"MSE": float(np.mean(diff ** 2))}

    def get_model(self):
        return self.model


class TF2Estimator:
    """ref: P:orca/learn/tf2/estimator.py — creator-function API over a
    host tf.keras model; the train loop is an explicit GradientTape step
    per batch, driven shard by shard. ``tensorflow`` is imported here, so
    this backend needs it installed."""

    def __init__(self, model_creator: Callable,
                 config: Optional[dict] = None,
                 compile_args_creator: Optional[Callable] = None):
        import tensorflow as tf

        self._tf = tf
        self.config = config or {}
        self.model = model_creator(self.config)
        if compile_args_creator is not None:
            self.model.compile(**compile_args_creator(self.config))
        if self.model.optimizer is None:
            raise ValueError("model_creator must compile the model or a "
                             "compile_args_creator must be given")

    def fit(self, data, epochs: int = 1, batch_size: int = 32):
        tf = self._tf
        model = self.model
        loss_fn = model.loss
        if isinstance(loss_fn, str):
            loss_fn = tf.keras.losses.get(loss_fn)
        opt = model.optimizer
        stats = []

        @tf.function
        def train_step(xb, yb):
            with tf.GradientTape() as tape:
                out = model(xb, training=True)
                loss = loss_fn(yb, out)
            grads = tape.gradient(loss, model.trainable_variables)
            opt.apply_gradients(zip(grads, model.trainable_variables))
            return loss

        for _ in range(epochs):
            shards = data.collect() if isinstance(data, XShards) else [data]
            for shard in shards:
                if isinstance(shard, dict):
                    x, y = shard["x"], shard["y"]
                else:
                    x, y = shard
                x, y = np.asarray(x), np.asarray(y)
                for i in range(0, len(x), batch_size):
                    loss = train_step(x[i:i + batch_size],
                                      y[i:i + batch_size])
                stats.append(float(loss))
        return stats

    def predict(self, data, batch_size: int = 128) -> np.ndarray:
        return np.asarray(self.model.predict(np.asarray(_features(data)),
                                             batch_size=batch_size,
                                             verbose=0))

    def evaluate(self, data, batch_size: int = 128) -> dict:
        x, y = _xy_from_data(data)
        pred = self.predict(x, batch_size)
        if pred.ndim > 1 and pred.shape[-1] > 1:
            acc = float((pred.argmax(-1)
                         == np.asarray(y).squeeze()).mean())
            return {"Accuracy": acc}
        diff = pred.squeeze() - np.asarray(y).squeeze()
        return {"MSE": float(np.mean(diff ** 2))}

    def get_model(self):
        return self.model

    def save(self, path: str):
        self.model.save_weights(path)
        return self

    def load(self, path: str):
        self.model.load_weights(path)
        return self


class Estimator:
    """Facade (ref: each backend module exposes Estimator.from_*)."""

    @staticmethod
    def from_bigdl(*, model, loss=None, optimizer=None, metrics=None,
                   device=None, distributed: Optional[bool] = None,
                   **_ignored) -> BigDLEstimator:
        return BigDLEstimator(model, loss, optimizer, metrics, device,
                              distributed)

    @staticmethod
    def from_torch(*, model_creator, optimizer_creator, loss_creator=None,
                   config=None, backend: str = "spark",
                   workers_per_node: int = 1, device=None,
                   **_ignored) -> TorchEstimator:
        # backend spark|ray|torch_distributed all collapse to the one
        # loop on ``device`` (no Spark/Ray substrate)
        return TorchEstimator(model_creator, optimizer_creator,
                              loss_creator, config, device)

    @staticmethod
    def from_keras(*, model_creator=None, config=None,
                   compile_args_creator=None, backend: str = "tf2",
                   model=None, loss=None, optimizer=None, metrics=None,
                   device=None, distributed: Optional[bool] = None,
                   **_ignored):
        """backend="tf2" hosts a foreign tf.keras model (creator-fn API,
        ref P:orca/learn/tf2); backend="bigdl" trains one of the port's
        Keras-API models through the ``Optimizer`` facade."""
        if backend == "bigdl" or model is not None:
            return BigDLEstimator(model, loss, optimizer, metrics, device,
                                  distributed)
        if backend != "tf2":
            raise ValueError(
                f"unknown from_keras backend {backend!r}: this build "
                "hosts 'tf2' (single-process tf.GradientTape loop) and "
                "'bigdl'; the reference's spark/ray/horovod substrates "
                "are absent from this environment")
        if model_creator is None:
            raise ValueError("tf2 backend needs model_creator")
        return TF2Estimator(model_creator, config, compile_args_creator)

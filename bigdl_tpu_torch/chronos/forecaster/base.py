"""Forecaster contract — the port of ``bigdl_tpu/chronos/forecaster/base.py``
(ref: P:chronos/forecaster/base_forecaster.py — fit/predict/evaluate over
numpy or TSDataset, pytorch(-lightning) models underneath).

The model is one of the port's DLlib ``nn`` modules on ``device``
(``None``: the GPU, see :func:`~bigdl_tpu_torch.device.resolve_device`),
and it is its own parameters: a train step runs the forward in training
mode, the criterion's loss, ``torch.autograd.grad`` over the parameters
and the port's :class:`~bigdl_tpu_torch.optim.Adam` on their list, then
rebinds each parameter to its new value. ``fit`` draws the
JAX package's batches (``np.random.RandomState(0)``, one permutation an
epoch, the tail dropped) and starts a fresh Adam state on each call, as
it does. The losses stay on the device until the fit ends
(``history``: one float a step).

Dropout draws from one explicit ``torch.Generator`` a layer on the
model's device, seeded from ``seed`` and the layer's position, so two
forecasters built with one seed train alike. The JAX package draws its
masks from ``jax.random`` keys, which torch cannot reproduce: the two
agree at dropout 0 and by contract (the keep rate) above it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.chronos import metric as M
from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.nn.module import to_numpy
from bigdl_tpu_torch.optim.optim_method import Adam


def _unpack(data) -> Tuple[np.ndarray, np.ndarray]:
    from bigdl_tpu_torch.chronos.data import TSDataset

    if isinstance(data, TSDataset):
        return data.to_numpy()
    x, y = data
    return np.asarray(x, np.float32), np.asarray(y, np.float32)


def _inputs(data) -> np.ndarray:
    from bigdl_tpu_torch.chronos.data import TSDataset

    if isinstance(data, tuple):
        return np.asarray(data[0], np.float32)
    if isinstance(data, TSDataset):
        return data.to_numpy()[0]
    return np.asarray(data, np.float32)


def seed_generators(model: torch.nn.Module, seed: int,
                    device: torch.device):
    """Give each stochastic layer of ``model`` its own generator on
    ``device``, seeded from ``seed`` and the layer's position."""
    layers = [m for m in model.modules() if hasattr(m, "_draw_generator")]
    for i, m in enumerate(layers):
        m.generator = torch.Generator(device=device).manual_seed(
            seed * 1_000_003 + i)


def apply_update(optim, lr, params, grads, opt_state):
    """``optim.step`` on the flat list of parameters and their gradients
    (the state made by ``optim.init_state(params)``), then each parameter
    rebound to its new value. Returns the new optimizer state."""
    new, opt_state = optim.step([p.detach() for p in params], list(grads),
                                opt_state, lr)
    for p, v in zip(params, new):
        p.data = v
    return opt_state


class BaseForecaster:
    """fit/predict/evaluate driver. Subclasses implement _build_model."""

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 lr: float = 1e-3, loss: str = "mse", seed: int = 0,
                 device=None):
        self.past_seq_len = past_seq_len
        self.future_seq_len = future_seq_len
        self.input_feature_num = input_feature_num
        self.output_feature_num = output_feature_num
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        nn.set_seed(seed)
        self.model = self._build_model().to(self.device)
        seed_generators(self.model, seed, self.device)
        self.criterion = {"mse": nn.MSECriterion,
                          "mae": nn.AbsCriterion}[loss]()
        self.history: list = []
        self._fitted = False

    def _build_model(self) -> nn.Module:
        raise NotImplementedError

    def _batch(self, a: np.ndarray) -> torch.Tensor:
        # a copy where ``a`` is a window view (read-only, strided)
        return torch.from_numpy(np.require(a, np.float32, ("C", "W"))).to(
            self.device)

    # -- training -------------------------------------------------------------
    def train_step(self, params, opt_state, optim, xb, yb):
        """One step on device batches: ``(loss tensor, new opt state)``;
        ``params`` are the model's parameters."""
        loss = self.criterion.apply_loss(self.model(xb), yb)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), apply_update(optim, self.lr, params, grads,
                                           opt_state)

    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            validation_data=None, shuffle: bool = True):
        x, y = _unpack(data)
        optim = Adam(learning_rate=self.lr)
        self.model.train()
        params = list(self.model.parameters())
        opt_state = optim.init_state(params)
        n = x.shape[0]
        rs = np.random.RandomState(0)
        losses = []
        for _ in range(epochs):
            order = rs.permutation(n) if shuffle else np.arange(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i:i + batch_size]
                loss, opt_state = self.train_step(
                    params, opt_state, optim, self._batch(x[idx]),
                    self._batch(y[idx]))
                losses.append(loss)
        self.history = torch.stack(losses).cpu().tolist() if losses else []
        self._fitted = True
        return self.history[-1] if losses else None

    # -- inference ------------------------------------------------------------
    def predict(self, data, batch_size: int = 128) -> np.ndarray:
        x = _inputs(data)
        model = self.model.evaluate()
        with torch.no_grad():
            outs = [to_numpy(model(self._batch(x[i:i + batch_size])))
                    for i in range(0, len(x), batch_size)]
        return np.concatenate(outs, 0) if outs else np.zeros(
            (0, self.future_seq_len, self.output_feature_num), np.float32)

    def evaluate(self, data, metrics: Sequence[str] = ("mse",),
                 batch_size: int = 128):
        x, y = _unpack(data)
        pred = self.predict(x, batch_size)
        return M.evaluate(y, pred, metrics)

    # -- persistence ----------------------------------------------------------
    def save(self, path: str):
        """The model in the checkpoint format (``Module.save_module``);
        the layers' generators are left out and seeded anew by
        :meth:`load`."""
        layers = [m for m in self.model.modules()
                  if getattr(m, "generator", None) is not None]
        held = [m.generator for m in layers]
        try:
            for m in layers:
                m.generator = None
            self.model.save_module(path)
        finally:
            for m, g in zip(layers, held):
                m.generator = g
        return self

    def load(self, path: str):
        self.model = nn.Module.load_module(path, device=self.device)
        seed_generators(self.model, self.seed, self.device)
        self._fitted = True
        return self

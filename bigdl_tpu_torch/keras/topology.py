"""Keras-style topology — the port of ``bigdl_tpu/keras/topology.py``:
``Sequential``, the functional ``Model`` and ``Input`` (ref: scala
.../dllib/keras, python dllib/keras).

Each :class:`KerasLayer` builds its ``nn`` module the moment its input
shape is known; ``Sequential`` chains them in an ``nn.Sequential``, the
functional ``Model`` lowers to :class:`~bigdl_tpu_torch.nn.graph.Graph`.
Shapes exclude the batch dim, Keras-1 style; the image layout is
channels-first (``th`` ordering), as ``nn``'s NCHW layers take it.

``compile`` / ``fit`` / ``evaluate`` / ``predict`` lower onto the port's
``optim``: ``fit`` builds ``optim.Optimizer``, whose
``distributed=True`` — ``fit``'s default, as in the JAX package, where
it builds ``DistriOptimizer`` — raises until distributed training is
ported (ROADMAP Queue 1 item 10); pass ``distributed=False`` for the
local optimizer. ``fit``, ``evaluate`` and ``predict`` take ``device=``
as the optimizer does: ``None`` is the GPU.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.nn.graph import Graph, Input as GraphInput, Node
from bigdl_tpu_torch.optim import optimizer as _optim
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger

logger = logging.getLogger("bigdl_tpu_torch.keras")

Shape = Tuple[int, ...]


class KerasTensor:
    """A symbolic tensor of the functional API: (shape sans batch, DAG
    node)."""

    def __init__(self, shape: Shape, node: Node):
        self.shape = tuple(shape)
        self.node = node

    def __repr__(self):
        return f"KerasTensor(shape={self.shape})"


def Input(shape: Shape, name: Optional[str] = None) -> KerasTensor:
    """The entry placeholder (ref: keras Input); ``shape`` excludes the
    batch."""
    return KerasTensor(shape, GraphInput(name))


class KerasLayer:
    """Base: subclasses implement ``build_module(input_shape)`` and
    ``compute_output_shape(input_shape)``."""

    def __init__(self, input_shape: Optional[Shape] = None,
                 name: Optional[str] = None, **kwargs):
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name
        self.built_module: Optional[nn.Module] = None
        self.output_shape: Optional[Shape] = None

    def build_module(self, input_shape: Shape) -> nn.Module:
        raise NotImplementedError

    def compute_output_shape(self, input_shape: Shape) -> Shape:
        raise NotImplementedError

    def build(self, input_shape: Shape) -> nn.Module:
        self.input_shape = tuple(input_shape)
        self.built_module = self.build_module(self.input_shape)
        if self.name:
            self.built_module.set_name(self.name)
        self.output_shape = tuple(
            self.compute_output_shape(self.input_shape))
        return self.built_module

    # functional API: layer(keras_tensor)
    def __call__(self, x: Union[KerasTensor, Sequence[KerasTensor]]):
        if isinstance(x, (list, tuple)):
            shapes = [t.shape for t in x]
            mod = self.build(shapes[0]) if not hasattr(
                self, "build_multi") else self.build_multi(shapes)
            node = mod.inputs(*[t.node for t in x])
        else:
            mod = self.build(x.shape)
            node = mod.inputs(x.node)
        return KerasTensor(self.output_shape, node)


class _Compiled:
    """compile / fit / evaluate / predict, shared by Sequential and
    Model."""

    def __init__(self):
        self._criterion = None
        self._optim_method: Optional[OptimMethod] = None
        self._metrics = []
        self._tb = None          # (log_dir, app_name)
        self._checkpoint = None  # (path, trigger)

    @property
    def module(self) -> nn.Module:
        raise NotImplementedError

    def compile(self, optimizer, loss, metrics: Optional[list] = None):
        from bigdl_tpu_torch.keras.metrics import to_validation_methods
        from bigdl_tpu_torch.keras.objectives import to_criterion
        from bigdl_tpu_torch.keras.optimizers import to_optim_method

        self._optim_method = to_optim_method(optimizer)
        self._criterion = to_criterion(loss)
        self._metrics = to_validation_methods(metrics or [])
        return self

    def set_tensorboard(self, log_dir: str, app_name: str):
        self._tb = (log_dir, app_name)
        return self

    def set_checkpoint(self, path: str, over_write: bool = True,
                       trigger: Optional[Trigger] = None):
        self._checkpoint = (path, trigger or Trigger.every_epoch())
        return self

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, distributed: bool = True, device=None):
        """Train through ``optim.Optimizer``: ``distributed=True`` (the
        default) raises until ROADMAP Queue 1 item 10."""
        self.fit_optimizer(x, y, batch_size, nb_epoch, validation_data,
                           distributed, device).optimize()
        return self

    def fit_optimizer(self, x, y=None, batch_size: int = 32,
                      nb_epoch: int = 10, validation_data=None,
                      distributed: bool = True, device=None):
        """The ``optim.Optimizer`` that :meth:`fit` builds and runs, built
        and not run (to time or trace its steps)."""
        if self._criterion is None:
            raise RuntimeError("call compile(...) before fit")
        data = x if y is None else (np.asarray(x), np.asarray(y))
        opt = _optim.Optimizer(
            self.module, data, self._criterion, batch_size=batch_size,
            end_trigger=Trigger.max_epoch(nb_epoch),
            distributed=distributed, device=device)
        opt.set_optim_method(self._optim_method)
        if validation_data is not None and self._metrics:
            opt.set_validation(Trigger.every_epoch(), validation_data,
                               self._metrics, batch_size)
        if self._tb is not None:
            from bigdl_tpu_torch.optim.summary import (TrainSummary,
                                                       ValidationSummary)
            opt.set_train_summary(TrainSummary(*self._tb))
            opt.set_val_summary(ValidationSummary(*self._tb))
        if self._checkpoint is not None:
            opt.set_checkpoint(*self._checkpoint)
        return opt

    def evaluate(self, x, y=None, batch_size: int = 32, device=None):
        data = x if y is None else (np.asarray(x), np.asarray(y))
        methods = self._metrics or []
        if not methods:
            from bigdl_tpu_torch.optim.validation import Loss
            methods = [Loss(self._criterion)]
        return _optim.Evaluator(self.module, device=device).evaluate(
            data, methods, batch_size)

    def predict(self, x, batch_size: int = 32, device=None):
        return _optim.Predictor(self.module, batch_size,
                                device=device).predict(np.asarray(x))

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True, device=None):
        out = self.predict(x, batch_size, device).argmax(axis=-1)
        return out if zero_based_label else out + 1

    def save_model(self, path: str, overwrite: bool = True):
        self.module.save_module(path, overwrite)
        return self

    def summary(self) -> str:
        text = repr(self.module)
        logger.info("%s", text)
        return text

    def get_weights(self):
        return self.module.get_weights()

    def set_weights(self, weights):
        self.module.set_weights(weights)
        return self


class Sequential(_Compiled):
    """A linear stack of layers (ref: keras Sequential)."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self._seq = nn.Sequential()
        if name:
            self._seq.set_name(name)
        self._layers: List[KerasLayer] = []
        self._cur_shape: Optional[Shape] = None

    @property
    def module(self) -> nn.Module:
        return self._seq

    @property
    def layers(self) -> List[KerasLayer]:
        return list(self._layers)

    def add(self, layer: KerasLayer):
        if isinstance(layer, Sequential):  # a nested model adds its layers
            for sub in layer._layers:
                self.add(sub)
            return self
        if self._cur_shape is None:
            if layer.input_shape is None:
                raise ValueError(
                    "first layer needs input_shape= (Keras-1 style)")
            shape = layer.input_shape
        else:
            shape = self._cur_shape
        self._seq.add(layer.build(shape))
        self._cur_shape = layer.output_shape
        self._layers.append(layer)
        return self

    def get_output_shape(self) -> Optional[Shape]:
        return self._cur_shape


class Model(_Compiled):
    """A functional DAG model (ref: keras Model), lowered to
    ``nn.graph.Graph``."""

    def __init__(self, input, output, name: Optional[str] = None):
        super().__init__()
        inputs = input if isinstance(input, (list, tuple)) else [input]
        outputs = output if isinstance(output, (list, tuple)) else [output]
        self._graph = Graph([t.node for t in inputs],
                            [t.node for t in outputs], name=name)
        self.inputs = list(inputs)
        self.outputs = list(outputs)

    @property
    def module(self) -> nn.Module:
        return self._graph

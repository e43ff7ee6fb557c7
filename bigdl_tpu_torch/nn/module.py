"""Module contract — the port of ``bigdl_tpu/nn/module.py`` (ref:
scala/dllib/.../nn/abstractnn/AbstractModule.scala).

A :class:`Module` is a ``torch.nn.Module`` that keeps the JAX package's
naming, so weights carry across key for key:

- children sit in ``_modules`` under the JAX package's keys (the JAX
  code writes ``self._modules["word"] = ...``; torch's ``_modules`` is
  also an ordered dict of children, so the same lines work);
- params are ``Parameter``s and states are buffers, under the same names
  (``weight``, ``bias``, ``q``, ``scale``, ``zero``);
- :meth:`parameters_dict` / :meth:`states_dict` return the JAX shape of
  nested dicts, and :meth:`load_parameters_dict` /
  :meth:`load_states_dict` take those trees as numpy arrays — what
  ``jax.tree_util.tree_map(np.asarray, m.parameters_dict())`` gives on
  the JAX side — or as tensors.

``forward`` is torch's. The JAX ``training()`` *method* would shadow
torch's ``training`` *attribute*, so the mode is torch's: ``train()``,
``eval()``, and :meth:`evaluate` as the BigDL name for ``eval()``. The
JAX package's ``backward``, ``Criterion`` and checkpoint methods are
training and persistence, still to port (ROADMAP Queue 1 item 9).

Parameter initialisation draws from :data:`RNG`, one CPU
``torch.Generator`` seeded by :func:`set_seed`: the same seed gives the
same weights wherever the module is later moved.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.llm.convert import tensor_from_numpy

_instance_counters: Dict[str, int] = {}

RNG = torch.Generator().manual_seed(0)   # parameter initialisation stream


def set_seed(seed: int):
    """Set the global parameter-initialisation seed."""
    RNG.manual_seed(seed)


def _auto_name(cls_name: str) -> str:
    n = _instance_counters.get(cls_name, 0)
    _instance_counters[cls_name] = n + 1
    return f"{cls_name}{n}"


def _carry(value, device: Optional[torch.device] = None) -> torch.Tensor:
    """A weight leaf (tensor or numpy array) as a tensor on ``device``
    (its own device when ``None``), detached from any graph."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        return t if device is None else t.to(device)
    return tensor_from_numpy(np.asarray(value), device or "cpu")


class Module(torch.nn.Module):
    """Base module (ref: AbstractModule[A, B, T])."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)

    # -- registration -------------------------------------------------------
    def add_param(self, name: str, value):
        self.register_parameter(name, torch.nn.Parameter(_carry(value)))

    def add_state(self, name: str, value):
        self.register_buffer(name, _carry(value))

    # -- tree collection ----------------------------------------------------
    def parameters_dict(self) -> Dict[str, Any]:
        d = dict(self._parameters)
        for name, mod in self._modules.items():
            sub = mod.parameters_dict()
            if sub:
                d[name] = sub
        return d

    def states_dict(self) -> Dict[str, Any]:
        d = dict(self._buffers)
        for name, mod in self._modules.items():
            sub = mod.states_dict()
            if sub:
                d[name] = sub
        return d

    def load_parameters_dict(self, params: Dict[str, Any]):
        """Replace each param named in ``params`` (numpy or tensor; it
        lands on the device of the param it replaces), recursively."""
        for k, old in list(self._parameters.items()):
            if k in params:
                self._parameters[k] = torch.nn.Parameter(
                    _carry(params[k], old.device),
                    requires_grad=old.requires_grad)
        for name, mod in self._modules.items():
            if name in params:
                mod.load_parameters_dict(params[name])
        return self

    def load_states_dict(self, states: Dict[str, Any]):
        """Replace each state named in ``states``, as
        :meth:`load_parameters_dict` does for params."""
        for k, old in list(self._buffers.items()):
            if k in states:
                self._buffers[k] = _carry(states[k], old.device)
        for name, mod in self._modules.items():
            if name in states:
                mod.load_states_dict(states[name])
        return self

    # -- modes ---------------------------------------------------------------
    def evaluate(self):
        """BigDL's name for ``eval()``."""
        return self.eval()

    def is_training(self) -> bool:
        return self.training


class TensorModule(Module):
    """Module whose input/output are single tensors (ref: TensorModule)."""

"""Module contract — the port of ``bigdl_tpu/nn/module.py`` (ref:
scala/dllib/.../nn/abstractnn/AbstractModule.scala).

A :class:`Module` is a ``torch.nn.Module`` that keeps the JAX package's
naming, so weights carry across key for key:

- children sit in ``_modules`` under the JAX package's keys (the JAX
  code writes ``self._modules["word"] = ...``; torch's ``_modules`` is
  also an ordered dict of children, so the same lines work);
- params are ``Parameter``s and states are buffers, under the same names
  (``weight``, ``bias``, ``running_mean``, ``q``, ``scale``, ``zero``);
- :meth:`parameters_dict` / :meth:`states_dict` return the JAX shape of
  nested dicts, and :meth:`load_parameters_dict` /
  :meth:`load_states_dict` take those trees as numpy arrays — what
  ``jax.tree_util.tree_map(np.asarray, m.parameters_dict())`` gives on
  the JAX side — or as tensors.

``forward`` is torch's. The JAX ``training()`` *method* would shadow
torch's ``training`` *attribute*, so the mode is torch's: ``train()``,
``eval()``, and :meth:`evaluate` as the BigDL name for ``eval()``. For
the same reason BigDL's ``parameters()`` pair ``(weights,
grad_weights)`` is :meth:`weights_and_grads`: torch's ``parameters()``
is used by torch itself (``requires_grad_``, ``to``) and keeps its
meaning.

:meth:`backward` is autograd over a re-run of ``forward`` (the JAX
package takes ``jax.vjp`` of ``apply``): it returns the input's gradient
and adds the parameters' into each parameter's ``.grad``
(:meth:`zero_grad_parameters` zeroes them). The re-run leaves the
running statistics as the forward left them, and a stochastic layer
replays the generator state of its last forward, so it sees the same
mask (the JAX code reuses ``_last_rng``). :class:`Criterion` is the loss
contract. :meth:`save_weights` / :meth:`load_weights` /
:meth:`save_module` / :meth:`load_module` write and read the JAX
package's checkpoint format (:mod:`bigdl_tpu_torch.utils.checkpoint`),
so either package loads the other's weights.

Parameter initialisation draws from :data:`RNG`, one CPU
``torch.Generator`` seeded by :func:`set_seed`: the same seed gives the
same weights wherever the module is later moved.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.llm.convert import tensor_from_numpy
from bigdl_tpu_torch.utils.table import Table
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map

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


def _flat_keys(tree, prefix=""):
    """Dotted paths of a nested-dict tree's leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_keys(v, f"{prefix}{k}.")
    else:
        yield prefix.rstrip(".")


def to_numpy(t) -> np.ndarray:
    """A tensor leaf as numpy (bf16 widened to f32, which is exact)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _structure(x):
    """``(leaves, rebuild)`` of an activity: a tensor, a list / tuple or
    a :class:`Table` of activities."""
    if isinstance(x, torch.Tensor):
        return [x], lambda leaves: leaves[0]
    if isinstance(x, Table):
        keys = list(x.keys())
        parts = [_structure(x[k]) for k in keys]
    elif isinstance(x, (list, tuple)):
        keys = None
        parts = [_structure(v) for v in x]
    else:
        return [x], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, rb), n in zip(parts, sizes):
            out.append(rb(leaves[i:i + n]))
            i += n
        if keys is None:
            return type(x)(out)
        t = Table()
        for k, v in zip(keys, out):
            t[k] = v
        return t

    return [leaf for p in parts for leaf in p[0]], rebuild


@contextlib.contextmanager
def replay_state(module: torch.nn.Module):
    """Run ``module`` again as its last forward ran: every stochastic
    layer restarts from the generator state of its last draw, and on
    exit the buffers (running statistics) and generators are put back as
    they were, so a re-run neither moves the statistics twice nor draws
    the stream further."""
    bufs = [(m, k, b) for m in module.modules()
            for k, b in m._buffers.items()]
    gens = [(m.generator, m.generator.get_state())
            for m in module.modules()
            if getattr(m, "_last_rng_state", None) is not None]
    for m in module.modules():
        if getattr(m, "_last_rng_state", None) is not None:
            m.generator.set_state(m._last_rng_state)
    try:
        yield
    finally:
        for m, k, b in bufs:
            m._buffers[k] = b
        for g, s in gens:
            g.set_state(s)


class Module(torch.nn.Module):
    """Base module (ref: AbstractModule[A, B, T])."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or _auto_name(type(self).__name__)
        self.grad_input = None

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

    # -- backward (BigDL's stateful facade) ----------------------------------
    def backward(self, x, grad_output):
        """updateGradInput + accGradParameters: the gradient of the input
        (the structure of ``x``; ``None`` for a leaf that is not a
        floating tensor), with each parameter's gradient added into its
        ``.grad``. Runs ``forward`` again under autograd, in the
        module's mode, with :func:`replay_state`."""
        leaves, rebuild = _structure(x)
        ins = [v.detach().requires_grad_(True)
               if isinstance(v, torch.Tensor) and v.is_floating_point()
               else v for v in leaves]
        with replay_state(self), torch.enable_grad():
            y = self.forward(rebuild(ins))
        outs, _ = _structure(y)
        gos, _ = _structure(grad_output)
        # an output that does not depend on what is differentiated (a
        # threshold's mask, prior boxes) has a zero gradient, as in JAX
        pairs = [(o, g) for o, g in zip(outs, gos)
                 if isinstance(o, torch.Tensor) and o.requires_grad]
        wanted = [v for v in ins
                  if isinstance(v, torch.Tensor) and v.requires_grad]
        params = [p for p in self.parameters() if p.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in pairs], wanted + params,
            [g for _, g in pairs], allow_unused=True) if pairs \
            else [None] * (len(wanted) + len(params))
        for p, g in zip(params, grads[len(wanted):]):
            if g is not None:
                p.grad = g if p.grad is None else p.grad + g
        by_id = {id(v): torch.zeros_like(v) if g is None else g
                 for v, g in zip(wanted, grads)}
        self.grad_input = rebuild([by_id.get(id(v)) for v in ins])
        return self.grad_input

    def update_grad_input(self, x, grad_output):
        return self.backward(x, grad_output)

    def zero_grad_parameters(self):
        for p in self.parameters():
            p.grad = torch.zeros_like(p)
        return self

    def weights_and_grads(self):
        """BigDL's ``parameters()``: flat ``(weights, grad_weights)``
        lists in the JAX package's leaf order (dict keys sorted)."""
        leaves = tree_leaves(self.parameters_dict())
        return leaves, [torch.zeros_like(w) if w.grad is None else w.grad
                        for w in leaves]

    def get_weights(self):
        return tree_map(to_numpy, self.parameters_dict())

    def set_weights(self, weights):
        return self.load_parameters_dict(weights)

    # -- modes ---------------------------------------------------------------
    def evaluate(self):
        """BigDL's name for ``eval()``."""
        return self.eval()

    def is_training(self) -> bool:
        return self.training

    # -- misc parity ----------------------------------------------------------
    def set_name(self, name: str):
        self.name = name
        return self

    def get_name(self) -> str:
        return self.name

    def reset(self):
        """Re-initialise parameters (ref: reset()). Default: the
        children's."""
        for m in self._modules.values():
            m.reset()
        return self

    def clear_state(self):
        self.grad_input = None
        for m in self._modules.values():
            m.clear_state()
        return self

    def inputs(self, *nodes):
        """BigDL's ``layer.inputs(node, ...)``: this module as a node of a
        :class:`~bigdl_tpu_torch.nn.graph.Graph` on the given parents."""
        from bigdl_tpu_torch.nn.graph import node_inputs
        return node_inputs(self, *nodes)

    def n_parameters(self) -> int:
        return sum(int(np.prod(p.shape))
                   for p in tree_leaves(self.parameters_dict()))

    # -- persistence ----------------------------------------------------------
    def save_weights(self, path: str):
        """Params and states in the JAX package's checkpoint format
        (``manifest.json`` + ``arrays.safetensors``)."""
        from bigdl_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(path, {"params": self.parameters_dict(),
                               "states": self.states_dict()},
                        metadata={"class": type(self).__name__})
        return self

    def load_weights(self, path: str, strict: bool = True) -> "Module":
        """Load params / states saved by :meth:`save_weights` (either
        package's). With ``strict`` the checkpoint must match this
        module's class and param keys."""
        from bigdl_tpu_torch.utils.checkpoint import load_checkpoint
        tree, meta = load_checkpoint(path)
        if strict:
            saved_cls = meta.get("class")
            if saved_cls is not None and saved_cls != type(self).__name__:
                raise ValueError(
                    f"checkpoint was saved from {saved_cls}, loading into "
                    f"{type(self).__name__} (pass strict=False to force)")
            want = set(_flat_keys(self.parameters_dict()))
            have = set(_flat_keys(tree["params"]))
            if want != have:
                raise ValueError(
                    f"checkpoint params do not match module: missing="
                    f"{sorted(want - have)[:5]} unexpected="
                    f"{sorted(have - want)[:5]} (pass strict=False)")
        self.load_parameters_dict(tree["params"])
        if tree.get("states"):
            self.load_states_dict(tree["states"])
        return self

    def save_module(self, path: str, overwrite: bool = True):
        """A checkpoint directory: the weights as :meth:`save_weights`
        writes them, plus ``structure.pkl``, this module pickled with
        empty CPU tensors for its weights, in one atomic save. The
        sidecar is this package's; the weights load in either."""
        if not overwrite and os.path.exists(path):
            raise IOError(f"{path} exists and overwrite=False")
        held = [(m, store, k, v) for m in self.modules()
                for store in (m._parameters, m._buffers)
                for k, v in store.items() if v is not None]
        try:
            for m, store, k, v in held:
                empty = torch.empty(0, dtype=v.dtype)
                store[k] = torch.nn.Parameter(
                    empty, requires_grad=v.requires_grad) \
                    if store is m._parameters else empty
            structure = pickle.dumps(self)
        finally:
            for m, store, k, v in held:
                store[k] = v
        from bigdl_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(path, {"params": self.parameters_dict(),
                               "states": self.states_dict()},
                        metadata={"class": type(self).__name__},
                        extra_files={"structure.pkl": structure})
        return self

    @staticmethod
    def load_module(path: str, device=None) -> "Module":
        """The module :meth:`save_module` wrote, with its weights, on
        ``device`` (``None``: the GPU, see ``resolve_device``)."""
        from bigdl_tpu_torch.device import resolve_device
        dev = resolve_device(device)
        with open(os.path.join(path, "structure.pkl"), "rb") as f:
            module = pickle.load(f)
        return module.load_weights(path).to(dev)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["grad_input"] = None
        state.pop("_last_rng_state", None)
        return state


class TensorModule(Module):
    """Module whose input/output are single tensors (ref: TensorModule)."""


class Stochastic:
    """Mixin of a layer that draws from its own ``torch.Generator``
    (``self.generator``: the one given, or one made at first use and
    seeded from the layer's name, as the JAX package folds the scope
    name into its key). :meth:`_draw_generator` records the state each
    draw starts from, which :meth:`Module.backward` replays."""

    generator: Optional[torch.Generator] = None

    def _draw_generator(self) -> torch.Generator:
        if self.generator is None:
            self.generator = torch.Generator().manual_seed(
                zlib.crc32(self.name.encode()))
        self._last_rng_state = self.generator.get_state()
        return self.generator

    def _rand(self, shape, like: torch.Tensor, normal: bool = False):
        g = self._draw_generator()
        draw = torch.randn if normal else torch.rand
        return draw(tuple(shape), generator=g, device=g.device).to(
            like.device)


class Criterion:
    """Loss contract (ref: AbstractCriterion): ``forward(input, target)``
    → float, ``backward(input, target)`` → the loss's gradient with
    respect to the input (autograd). :meth:`apply_loss` is the loss as a
    0-d tensor, what the optimizer differentiates."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average
        self.output = None
        self.grad_input = None

    def apply_loss(self, x, target):
        raise NotImplementedError

    def forward(self, x, target):
        self.output = self.apply_loss(x, target)
        return float(self.output)

    __call__ = forward

    def backward(self, x, target):
        leaves, rebuild = _structure(x)
        ins = [v.detach().requires_grad_(True) for v in leaves]
        with torch.enable_grad():
            loss = self.apply_loss(rebuild(ins), target)
        self.grad_input = rebuild(list(torch.autograd.grad(loss, ins)))
        return self.grad_input

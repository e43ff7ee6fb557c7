"""nano Trainer — the port of ``bigdl_tpu/nano/trainer.py`` (ref:
P:nano/pytorch/trainer.py — a pytorch-lightning Trainer subclass with
channels_last/ipex/bf16 AND multi-instance training knobs). ``fit``
trains through the port's ``LocalOptimizer`` on ``device``; the
precision knob casts the float params (and the input batches) to bf16;
``num_processes > 1`` runs the reference's multi-instance role on the
Orca ``RayContext`` spawn-process pool.

Multi-instance semantics (the JAX package's): the dataset splits into
``num_processes`` shards; each round, every worker process loads the
current parameters, trains one epoch on its shard, and the driver
averages the returned parameters and optimizer slots (local SGD). The
workers take the Trainer's device: on a GPU they share the one card,
each with a CUDA context of its own.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.nn.module import Criterion, Module, to_numpy
from bigdl_tpu_torch.utils.tree import tree_map

_BF16 = ("bf16", "16-mixed", "bf16-mixed")


def _host(tree):
    """A tree's tensors as numpy (the pool's transport; bf16 widened)."""
    return tree_map(lambda a: to_numpy(a) if isinstance(a, torch.Tensor)
                    else a, tree)


def _cast_params(model, dtype):
    """The model's f32 params cast to ``dtype`` (a no-op for ``None``)."""
    if dtype is not None:
        model.load_parameters_dict(tree_map(
            lambda a: a.to(dtype) if a.dtype == torch.float32 else a,
            model.parameters_dict()))


def _round_task(args):
    """One worker round: load the model and the current params (and the
    carried optimizer state), train an epoch on the shard, return the
    trained params, the loss and the optimizer state, so the NEXT round
    resumes instead of resetting momenta / LR-schedule counters (runs in
    a spawned worker; module level so the standard library's pickle
    carries it)."""
    (model_path, params, x, y, batch_size, criterion, optim_method,
     host_state, opt_state, device, input_dtype) = args
    from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
    from bigdl_tpu_torch.optim.trigger import Trigger

    model = Module.load_module(model_path, device=device)
    model.load_parameters_dict(params)
    _cast_params(model, input_dtype)   # the pool carries them widened
    opt = LocalOptimizer(model, (x, y), criterion, batch_size=batch_size,
                         end_trigger=Trigger.max_epoch(1), device=device)
    opt.set_input_dtype(input_dtype)
    if optim_method is not None:
        opt.set_optim_method(optim_method)
    if host_state is not None:
        opt.optim_method.load_state(host_state)
    if opt_state is not None:
        opt._resume_opt_state = tree_map(
            lambda a: torch.from_numpy(np.array(a))
            if isinstance(a, np.ndarray) else a, opt_state)
    opt.optimize()
    return (_host(model.parameters_dict()), opt.state["loss"],
            opt.optim_method.get_state(), _host(opt._last_opt_state))


class Trainer:
    def __init__(self, max_epochs: int = 1, precision: str = "32",
                 use_ipex: bool = False, num_processes: int = 1,
                 round_timeout: float = 3600.0, device=None, **kwargs):
        self.max_epochs = max_epochs
        self.precision = str(precision)
        self.num_processes = num_processes
        self.round_timeout = round_timeout
        self.device = resolve_device(device)
        self.last_losses: list = []

    def fit(self, model: Module, criterion: Criterion, x: np.ndarray,
            y: np.ndarray, batch_size: int = 32, optim_method=None):
        from bigdl_tpu_torch.optim.optimizer import LocalOptimizer
        from bigdl_tpu_torch.optim.trigger import Trigger

        model = getattr(model, "module", model).to(self.device)
        input_dtype = torch.bfloat16 if self.precision in _BF16 else None
        _cast_params(model, input_dtype)
        if self.num_processes > 1:
            return self._fit_multi_instance(model, criterion,
                                            np.asarray(x), np.asarray(y),
                                            batch_size, optim_method,
                                            input_dtype)
        opt = LocalOptimizer(model, (np.asarray(x), np.asarray(y)),
                             criterion, batch_size=batch_size,
                             end_trigger=Trigger.max_epoch(
                                 self.max_epochs), device=self.device)
        opt.set_input_dtype(input_dtype)
        if optim_method is not None:
            opt.set_optim_method(optim_method)
        opt.optimize()
        self.last_losses = [opt.state["loss"]]
        return model

    def _fit_multi_instance(self, model, criterion, x, y, batch_size,
                            optim_method, input_dtype):
        from bigdl_tpu_torch.orca.ray_pool import RayContext

        n = self.num_processes
        idx = np.array_split(np.arange(len(x)), n)
        params = _host(model.parameters_dict())
        self.last_losses = []
        host_state = None          # optimizer counters / LR schedule
        opt_state = None           # momenta etc., averaged like params
        with tempfile.TemporaryDirectory() as td, \
                RayContext(num_workers=n) as ctx:
            model_path = os.path.join(td, "model")
            model.save_module(model_path)
            for _ in range(self.max_epochs):     # one sync per epoch
                outs = ctx.map(_round_task,
                               [(model_path, params, x[i], y[i],
                                 batch_size, criterion, optim_method,
                                 host_state, opt_state, str(self.device),
                                 input_dtype)
                                for i in idx],
                               timeout=self.round_timeout)
                trees = [o[0] for o in outs]
                self.last_losses.append(
                    float(np.mean([o[1] for o in outs])))
                params = tree_map(
                    lambda *vs: np.mean(np.stack(vs), axis=0).astype(
                        vs[0].dtype), *trees)
                # carry optimizer state across rounds: counters from
                # worker 0 (identical on all), slot arrays averaged the
                # same way as the parameters they track
                host_state = outs[0][2]
                slots = [o[3] for o in outs]
                if all(s is not None for s in slots):
                    opt_state = tree_map(
                        lambda *vs: (np.mean(np.stack(vs), axis=0)
                                     if np.asarray(vs[0]).dtype.kind
                                     == "f" else vs[0]), *slots)
        model.load_parameters_dict(params)
        _cast_params(model, input_dtype)   # the averaged tree is widened
        return model

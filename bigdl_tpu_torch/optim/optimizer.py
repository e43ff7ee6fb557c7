"""Training orchestration — the port of ``bigdl_tpu/optim/optimizer.py``
(ref: .../optim/Optimizer.scala, LocalOptimizer.scala).

The training loop is the JAX package's: triggers, validation,
checkpointing with auto-resume, ``set_max_retry``'s replay, the
preemption handler, summaries, the per-phase ``Metrics`` timers, the
``bigdl_train_*`` series and the ``train/epoch`` / ``train/step`` spans.
The train step runs eagerly on ``device``: the model's forward in
training mode, the criterion's loss, ``torch.autograd.grad`` over the
parameters, constant clipping then L2-norm clipping, and the optim
method's ``step`` on the parameter tree — the order of the JAX
``_build_step``. The live parameters are rebound to the new values, so
the model is always the trained one.

Batches are staged by :class:`BatchPrefetcher` (a thread; on the GPU a
pinned host copy and a non-blocking copy on a side stream, the compute
stream waiting on its event), and the loss is read one step late
(:meth:`BaseOptimizer._drain_loss`), so the host enqueues step N+1 while
the card runs step N; no ``.item()`` in the step.

Entry points take ``device=``: ``None`` is the GPU
(:func:`~bigdl_tpu_torch.device.resolve_device` raises without one).

:class:`DistriOptimizer` is data-parallel training over the Engine's
mesh (``torch.distributed``: NCCL on the card, gloo on the CPU), one
process a device; ``batch_size`` is the global batch. Each rank draws
the same shuffled global batch from a ``LocalDataSet`` and trains on
its contiguous ``1 / W`` slice (a ``DistributedDataSet`` gives each rank
its own samples, batched ``batch_size / W`` at a time). The gradients
are averaged over the data group before clipping, the loss is averaged
across ranks, and every rank applies the same update. Without gradient
compression batch normalisation takes the global batch's statistics
(the JAX package's SPMD step); under bf16 / int8 compression each rank
normalises its own shard and the float states are averaged after the
step (its ``shard_map`` step).

With ``bigdl.elastic.enabled`` the loop drives
:class:`~bigdl_tpu_torch.elastic.TrainElastic` as the JAX package's
does: a step heartbeat and an abort check at the top of each iteration,
a host snapshot into the ring every ``bigdl.elastic.snapshot.every``
iterations, durable flushes of committed snapshots, an in-process
rollback to the ring (one process) or an exit the elastic launcher
answers with a new worker set (several), and auto-resume from the
checkpoint directory whether or not the reliability switch is on.
Switched off, nothing of the elastic package is imported or started.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import queue as _queue
import signal
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch import observability as obs
from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.device import resolve_device
from bigdl_tpu_torch.feature.dataset import (AbstractDataSet,
                                             DistributedDataSet, LocalDataSet,
                                             SampleToMiniBatch)
from bigdl_tpu_torch.nn.module import Criterion, Module, to_numpy
from bigdl_tpu_torch.observability import utilization
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map, \
    tree_unflatten

logger = logging.getLogger("bigdl_tpu_torch.optim")

def _grad_norm(grads):
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def _train_instruments():
    """Declare (or fetch) the training metrics — called only when
    observability is enabled, so disabled runs leave the registry
    untouched."""
    return {
        "step": obs.histogram(
            "bigdl_train_step_seconds",
            "Wall time of one optimizer iteration (data wait + step "
            "dispatch; the loop is pipelined, so this bounds dispatch, "
            "not device occupancy)"),
        "data_wait": obs.counter(
            "bigdl_train_data_wait_seconds_total",
            "Cumulative host time spent staging input batches"),
        "compute": obs.counter(
            "bigdl_train_compute_seconds_total",
            "Cumulative host time spent dispatching the compiled step"),
        "examples": obs.counter(
            "bigdl_train_examples_total",
            "Training examples consumed"),
        "steps": obs.counter(
            "bigdl_train_steps_total", "Optimizer steps taken"),
        "loss": obs.gauge("bigdl_train_loss", "Last drained train loss"),
        "lr": obs.gauge("bigdl_train_learning_rate",
                        "Learning rate at the last drained step"),
        "grad_norm": obs.gauge(
            "bigdl_train_grad_norm",
            "Global gradient L2 norm at the last drained step"),
        "throughput": obs.gauge(
            "bigdl_train_throughput_examples_per_sec",
            "Throughput of the last completed epoch"),
    }


def _module_device(model: torch.nn.Module) -> torch.device:
    p = next(iter(model.parameters()), None)
    if p is None:
        p = next(iter(model.buffers()), None)
    return torch.device("cpu") if p is None else p.device


def _to_dev(a, device, dtype=None):
    """A host batch (numpy or tensor; a list of them) on ``device``;
    floating leaves cast to ``dtype`` when one is given."""
    if isinstance(a, (list, tuple)):
        return [_to_dev(v, device, dtype) for v in a]
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    else:
        t = t.to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _generator_states(model) -> dict:
    """Each stochastic layer's generator state, keyed by the layer's
    index in ``model.modules()`` (the checkpoint's ``rng`` layout)."""
    return {str(i): m.generator.get_state()
            for i, m in enumerate(model.modules())
            if getattr(m, "generator", None) is not None}


def _load_generator_states(model, rng: Optional[dict]):
    for i, m in enumerate(model.modules()):
        g = (rng or {}).get(str(i))
        if g is not None and hasattr(m, "_draw_generator"):
            m._draw_generator().set_state(g)


@contextlib.contextmanager
def _weights_in_place(model, params, states):
    """Point the model's params (``.data``) and buffers at the trees'
    tensors for the block, then give each back its own tensor: the
    Parameter objects the training loop holds stay the model's. ``None``
    trees leave the model as it is."""
    undo = []

    def swap(mod, p, s):
        for k, par in mod._parameters.items():
            if par is not None and p is not None and k in p:
                undo.append((par, None, par.data))
                par.data = p[k]
        for k, buf in mod._buffers.items():
            if buf is not None and s is not None and k in s:
                undo.append((mod, k, buf))
                mod._buffers[k] = s[k]
        for name, sub in mod._modules.items():
            swap(sub, None if p is None else p.get(name, {}),
                 None if s is None else s.get(name, {}))

    try:
        swap(model, params, states)
        yield model
    finally:
        for owner, k, old in reversed(undo):
            if k is None:
                owner.data = old
            else:
                owner._buffers[k] = old


class BatchPrefetcher:
    """Double-buffered host→device batch staging: a thread runs
    ``place_fn`` (the optimizer's ``_place_batch``) for upcoming batches
    while the current step runs, holding at most ``depth`` staged
    batches. Yields ``(x, t, ready, size)``; errors in the producer
    surface on the consumer; ``close()`` retires the producer. Gated by
    ``bigdl.train.prefetch`` (default true)."""

    _END = object()

    def __init__(self, batches, place_fn, depth: int = 2):
        self._q: "_queue.Queue" = _queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(batches, place_fn), daemon=True)
        self._thread.start()

    def _run(self, batches, place_fn):
        try:
            for mb in batches:
                item = place_fn(mb.get_input(), mb.get_target())
                if not self._put(item + (mb.size(),)):
                    return
            self._put(self._END)
        except BaseException as e:  # surface errors on the consumer
            self._put(e)

    def _put(self, item) -> bool:
        # a bounded put that gives up when the consumer is gone
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        return item

    def close(self):
        self._stop.set()
        try:                       # unblock a producer stuck on put()
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class BaseOptimizer:
    """Shared training loop (ref: Optimizer.scala)."""

    def __init__(self, model: Module, dataset: AbstractDataSet,
                 criterion: Criterion, batch_size: int = 32,
                 end_trigger: Optional[Trigger] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if isinstance(dataset, tuple) and len(dataset) == 2 and \
                hasattr(dataset[0], "__len__"):
            dataset = LocalDataSet(*dataset)
        self.dataset = dataset
        self.criterion = criterion
        self.batch_size = batch_size
        self.end_trigger = end_trigger or Trigger.max_epoch(1)
        self.optim_method: OptimMethod = SGD()
        self.metrics = Metrics()
        self.state = {"epoch": 1, "neval": 1, "iteration_done": 0,
                      "loss": float("nan"), "record_count": 0,
                      "batch_in_epoch": 0}
        self._resume_opt_state = None
        self._checkpoint_path: Optional[str] = None
        self._checkpoint_trigger: Optional[Trigger] = None
        self._validation_trigger: Optional[Trigger] = None
        self._validation_dataset = None
        self._validation_methods: Sequence[ValidationMethod] = ()
        self._train_summary = None
        self._val_summary = None
        self._clip_l2: Optional[float] = None
        self._clip_const: Optional[tuple] = None
        self._max_retry: Optional[int] = None
        self._input_dtype: Optional[torch.dtype] = None
        self._copy_stream = None
        self._last_opt_state = None

    # -- setters (ref: Optimizer setters) -------------------------------------
    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    set_optim_methods = set_optim_method

    def set_end_when(self, trigger: Trigger):
        self.end_trigger = trigger
        return self

    def set_checkpoint(self, path: str, trigger: Trigger):
        os.makedirs(path, exist_ok=True)
        self._checkpoint_path = path
        self._checkpoint_trigger = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None):
        self._validation_trigger = trigger
        self._validation_dataset = dataset
        self._validation_methods = list(methods)
        self._validation_batch = batch_size or self.batch_size
        return self

    def set_train_summary(self, summary):
        self._train_summary = summary
        return self

    def set_val_summary(self, summary):
        self._val_summary = summary
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        self._clip_l2 = clip_norm
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float):
        self._clip_const = (min_v, max_v)
        return self

    def disable_gradient_clipping(self):
        self._clip_l2 = None
        self._clip_const = None
        return self

    def set_max_retry(self, n: int):
        """Iteration-retry budget (ref: DistriOptimizer's maxRetry): on an
        exception in the train loop, restore the newest valid checkpoint
        (``set_checkpoint``) — or the initial weights and counters when
        there is none — and replay. Also the config key
        ``bigdl.optimizer.max.retry``."""
        self._max_retry = int(n)
        return self

    def set_input_dtype(self, dtype: Optional[torch.dtype]):
        """Cast each floating input batch to ``dtype`` on the device after
        its copy (the port's way to feed bf16 inputs: numpy has no bf16;
        the JAX package's callers pass bf16 arrays)."""
        self._input_dtype = dtype
        return self

    def set_drop_module_property(self, *a, **k):  # parity no-op
        logger.warning("straggler dropPercentage applies to distributed "
                       "training only; ignoring")
        return self

    # -- the step -------------------------------------------------------------
    def _train_step(self, leaves, tree, opt_state, x, t, lr):
        """One iteration, eagerly: ``(loss, telemetry, new opt state)``."""
        with self._forward_context():
            loss = self.criterion.apply_loss(self.model(x), t)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss, grads = self._reduce(loss.detach(), grads)
        tele = {"grad_norm": _grad_norm(grads)} if self._obs else {}
        if self._clip_const is not None:
            lo, hi = self._clip_const
            grads = [torch.clamp(g, lo, hi) for g in grads]
        if self._clip_l2 is not None:
            scale = torch.clamp(
                self._clip_l2 / (_grad_norm(grads) + 1e-12), max=1.0)
            grads = [g * scale for g in grads]
        params = tree_unflatten(tree, [p.detach() for p in leaves])
        new, opt_state = self.optim_method.step(
            params, tree_unflatten(tree, grads), opt_state, lr)
        # rebind, not copy_: the step's results are fresh tensors, and a
        # tree loaded from another module may share a parameter's storage
        for p, v in zip(leaves, tree_leaves(new)):
            p.data = v
        return loss, tele, opt_state

    def _forward_context(self):
        return contextlib.nullcontext()

    def _reduce(self, loss, grads):
        """The step's loss and gradients as the update sees them: this
        process's own in one process."""
        return loss, grads

    def _batcher(self):
        return SampleToMiniBatch(self.batch_size)

    def _place_batch(self, x, t):
        """``(x, t, ready)`` on the device; on the GPU the copies run on a
        side stream and ``ready`` is the event the step waits on."""
        dev = self.device
        if dev.type != "cuda":
            return (_to_dev(x, dev, self._input_dtype),
                    _to_dev(t, dev), None)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._copy_stream):
            xd = _to_dev(x, dev, self._input_dtype)
            td = _to_dev(t, dev)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return xd, td, ready

    def _staged_batches(self, source):
        """Synchronous staging (``bigdl.train.prefetch=false``)."""
        for mb in source:
            yield self._place_batch(mb.get_input(), mb.get_target()) \
                + (mb.size(),)

    # -- the training loop ----------------------------------------------------
    def optimize(self) -> Module:
        from bigdl_tpu_torch.utils.conf import conf

        retries = self._max_retry if self._max_retry is not None \
            else (conf.get_int("bigdl.optimizer.max.retry", 0) or 0)
        attempt = 0
        # elastic supervision: constructed ONLY when enabled — a
        # disabled run has no agent thread, no ring, no series
        self._elastic = None
        elastic_restarts = 0
        if conf.get_bool("bigdl.elastic.enabled", False):
            from bigdl_tpu_torch import elastic
            self._elastic = elastic.TrainElastic.from_conf().start()
            if getattr(self.dataset, "_shuffle", False):
                # exact resume re-skips the interrupted epoch's batches by
                # COUNT; a stateful shuffle gives a restarted process
                # another permutation, so the skip drops the wrong samples
                logger.warning(
                    "elastic exact-resume requires a deterministic "
                    "per-epoch data order, but %s shuffles with "
                    "process-local RNG state — a resumed run may diverge "
                    "from an uninterrupted one (use shuffle=False)",
                    type(self.dataset).__name__)
        if retries or self._elastic is not None:
            # checkpoint-less recovery restarts from the initial weights
            # AND counters (fresh weights with advanced counters would
            # under-train)
            self._initial_snapshot = (
                tree_map(lambda a: a.detach().cpu().clone(),
                         self.model.parameters_dict()),
                tree_map(lambda a: a.detach().cpu().clone(),
                         self.model.states_dict()),
                copy.deepcopy(dict(self.state)),
                copy.deepcopy(self.optim_method.get_state()))
        rel_on = reliability.enabled()
        if rel_on or self._elastic is not None:
            # a fresh run against a directory holding valid state (the
            # previous process was preempted, or a restarted elastic
            # generation finds the durable snapshot tier) resumes where
            # it stopped — elastic recovery must not depend on the
            # unrelated reliability switch
            self._maybe_auto_resume()
        policy = reliability.RetryPolicy() if rel_on else None
        backoff = policy.delays() if rel_on else iter(())
        backoff_floor = policy.max_delay if rel_on else 0.0
        restore_handlers = self._install_preemption_handlers() \
            if rel_on else None
        try:
            while True:
                try:
                    return self._optimize_once()
                except (KeyboardInterrupt, reliability.TrainingPreempted):
                    raise    # preemption is not a failure: no retry
                except Exception as e:  # noqa: BLE001 — retry contract
                    if self._elastic is not None and \
                            self._elastic.owns(e):
                        if self._elastic.process_restart_required():
                            # the whole worker set restarts together
                            # (rejoining a collective solo would hang on
                            # peers that are also restarting): persist
                            # the newest committed snapshot and let the
                            # launcher respawn the world
                            self._elastic.abort_flush(self)
                            raise
                        elastic_restarts += 1
                        if elastic_restarts > self._elastic.max_restarts:
                            raise
                        logger.warning("elastic restart %d/%d: %s",
                                       elastic_restarts,
                                       self._elastic.max_restarts, e)
                        self._elastic.on_restart()
                        if not self._elastic.rollback(self):
                            self._restore_latest_checkpoint()
                        continue
                    attempt += 1
                    if attempt > retries:
                        raise
                    logger.warning(
                        "training iteration failed (%s: %s); retry %d/%d "
                        "from the last checkpoint", type(e).__name__, e,
                        attempt, retries)
                    from bigdl_tpu_torch.reliability.policies import _count
                    _count("bigdl_reliability_retries_total",
                           "Retries performed under a RetryPolicy",
                           component="optimizer")
                    time.sleep(next(backoff, backoff_floor))
                    self._restore_latest_checkpoint()
        finally:
            if restore_handlers is not None:
                restore_handlers()
            if self._elastic is not None:
                self._elastic.close()

    # -- preemption safety ----------------------------------------------------
    def _install_preemption_handlers(self):
        """SIGTERM / SIGINT → checkpoint at the next iteration boundary,
        then raise ``TrainingPreempted``. Installed only on the main
        thread and with a checkpoint path, and always restored."""
        if not self._checkpoint_path:
            return None
        if threading.current_thread() is not threading.main_thread():
            return None
        self._preempt_requested = False
        optimizer = self

        def on_signal(signum, frame):
            if optimizer._preempt_requested:
                raise KeyboardInterrupt   # a second signal insists
            optimizer._preempt_requested = True
            optimizer._preempt_signum = signum

        prev = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, on_signal)
        except (ValueError, OSError):
            for sig, h in prev.items():
                signal.signal(sig, h)
            return None

        def restore():
            for sig, h in prev.items():
                signal.signal(sig, h)

        return restore

    def _check_preemption(self, opt_state, state):
        if not getattr(self, "_preempt_requested", False):
            return
        self._preempt_requested = False
        self._drain_loss()
        if self._checkpoint_path:
            self._save_checkpoint(opt_state, state)
        from bigdl_tpu_torch.reliability.policies import _count
        _count("bigdl_reliability_preemptions_total",
               "SIGTERM/SIGINT preemptions that checkpointed and exited")
        signum = getattr(self, "_preempt_signum", signal.SIGTERM)
        logger.warning(
            "preemption signal %s: checkpoint saved at iteration %d; "
            "exiting (a fresh optimize() resumes here)", signum,
            state["neval"])
        raise reliability.TrainingPreempted(
            f"preempted at iteration {state['neval']} "
            f"(checkpoint: {self._checkpoint_path})")

    def _maybe_auto_resume(self):
        """On a fresh optimizer pointed at a checkpoint directory holding
        a valid pair, resume at the saved iteration."""
        from bigdl_tpu_torch.utils import checkpoint as ckpt
        if not self._checkpoint_path or self.state.get("iteration_done"):
            return
        tag = ckpt.latest(self._checkpoint_path, prefix="optim.",
                          paired_prefix="model.")
        if tag is not None:
            logger.info("auto-resuming from checkpoint %s @ %s",
                        self._checkpoint_path, tag)
            self.resume_from_checkpoint(self._checkpoint_path, tag)

    def _restore_latest_checkpoint(self):
        """Resume from the newest valid checkpoint when there is one,
        else from the initial weights and counters."""
        if self._checkpoint_path and os.path.isdir(self._checkpoint_path):
            from bigdl_tpu_torch.utils import checkpoint as ckpt
            tag = ckpt.latest(self._checkpoint_path, prefix="optim.",
                              paired_prefix="model.")
            if tag is not None:
                self.resume_from_checkpoint(self._checkpoint_path, tag)
                return
        p0, s0, ts0, hs0 = self._initial_snapshot
        self.model.load_parameters_dict(p0)
        self.model.load_states_dict(s0)
        self.state.clear()
        self.state.update(copy.deepcopy(ts0))
        self.optim_method.load_state(copy.deepcopy(hs0))

    def _optimize_once(self) -> Module:
        dev = self.device
        tree = self.model.parameters_dict()
        leaves = tree_leaves(tree)
        params = tree_unflatten(tree, [p.detach() for p in leaves])
        if self._resume_opt_state is not None:
            opt_state = tree_map(
                lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a,
                self._resume_opt_state)
            self._resume_opt_state = None
        else:
            opt_state = self.optim_method.init_state(params)

        batcher = self._batcher()
        state = self.state
        end_uses_loss = getattr(self.end_trigger, "uses_loss", False)
        self._pending_loss = None
        # observability is sampled once per run: the hot loop sees a bool
        self._obs = obs.enabled()
        ins = _train_instruments() if self._obs else None
        self._obs_ins = ins

        from bigdl_tpu_torch.utils.conf import conf
        prefetch_on = conf.get_bool("bigdl.train.prefetch", True)
        prefetch_depth = conf.get_int("bigdl.train.prefetch.depth", 2)
        self.model.train()

        while not self.end_trigger(state):
            records = 0
            t_epoch = time.perf_counter()
            ended_mid_epoch = False
            source = batcher(self.dataset.data(train=True))
            # a checkpoint taken inside an epoch recorded how many batches
            # the epoch had consumed: skip them unplaced
            for _ in range(int(state.get("batch_in_epoch", 0) or 0)):
                if next(source, None) is None:
                    break
            batches = BatchPrefetcher(source, self._place_batch,
                                      depth=prefetch_depth) \
                if prefetch_on else self._staged_batches(source)
            try:
                with obs.span("train/epoch", epoch=state["epoch"]):
                    while True:
                        t0 = time.perf_counter()
                        item = next(batches, None)
                        t_data = time.perf_counter() - t0
                        if item is None:
                            break
                        x, t, ready, nrec = item
                        if ready is not None:
                            cur = torch.cuda.current_stream(dev)
                            cur.wait_event(ready)
                            for a in (x if isinstance(x, list) else [x]) \
                                    + (t if isinstance(t, list) else [t]):
                                a.record_stream(cur)
                        reliability.inject("optimizer.step")
                        if self._elastic is not None:
                            # fault site + step heartbeat + abort check:
                            # a directed or stalled world aborts HERE,
                            # before a collective its peers never join
                            self._elastic.on_step_begin(state)
                        with obs.span("train/step", step=state["neval"]):
                            self.metrics.add("data", t_data)
                            lr = self.optim_method.current_lr()
                            t0 = time.perf_counter()
                            loss, tele, opt_state = self._train_step(
                                leaves, tree, opt_state, x, t, lr)
                            t_compute = time.perf_counter() - t0
                            self.metrics.add("compute", t_compute)
                            utilization.observe("optimizer/train_step",
                                                t_compute)
                            # the loss is read one step late, so the
                            # host enqueues N+1 while the card runs N
                            self._drain_loss()
                            self._pending_loss = (loss, tele,
                                                  state["neval"], lr)
                            records += nrec
                            state["record_count"] += nrec
                            if ins is not None:
                                ins["step"].observe(t_data + t_compute)
                                ins["data_wait"].inc(t_data)
                                ins["compute"].inc(t_compute)
                                ins["examples"].inc(nrec)
                                ins["steps"].inc()
                        self.optim_method.host_state["eval_counter"] += 1
                        state["neval"] += 1
                        state["iteration_done"] += 1
                        state["batch_in_epoch"] = \
                            state.get("batch_in_epoch", 0) + 1
                        self._after_iteration(opt_state, state)
                        if self._elastic is not None:
                            # snapshot cadence + durable flush, after the
                            # triggers so a snapshot carries their effects
                            self._elastic.on_step_end(self, opt_state,
                                                      state)
                        self._check_preemption(opt_state, state)
                        if end_uses_loss:
                            self._drain_loss()
                        if self.end_trigger(state):
                            ended_mid_epoch = True
                            break
            finally:
                if isinstance(batches, BatchPrefetcher):
                    batches.close()
                if self._elastic is not None:
                    # epoch-boundary work (validation, checkpointing) keeps
                    # the loop from its step heartbeat: park the watchdog
                    # until the next step re-arms it
                    self._elastic.on_loop_exit()
            self._drain_loss()
            thr = records / max(time.perf_counter() - t_epoch, 1e-9)
            logger.info(
                "Epoch %d done: loss=%.6f throughput=%.1f records/s (%s)",
                state["epoch"], state["loss"], thr, self.metrics.summary())
            if ins is not None:
                ins["throughput"].set(thr)
            if self._train_summary is not None:
                self._train_summary.add_scalar(
                    "Throughput", thr, state["neval"])
            if ended_mid_epoch:
                # the end trigger fired inside the epoch: the epoch
                # counter stays, but epoch-cadence triggers get a last pass
                state["epoch_finished"] = True
                self._after_iteration(opt_state, state)
                state["epoch_finished"] = False
                break
            state["epoch"] += 1
            state["batch_in_epoch"] = 0
            self.optim_method.host_state["epoch"] = state["epoch"]
            state["epoch_finished"] = True
            self._after_iteration(opt_state, state)
            state["epoch_finished"] = False
        self._last_opt_state = opt_state
        return self.model

    def _drain_loss(self):
        pending = getattr(self, "_pending_loss", None)
        if pending is not None:
            dev_loss, tele, neval, lr = pending
            self.state["loss"] = float(dev_loss)
            ins = getattr(self, "_obs_ins", None)
            if ins is not None:
                ins["loss"].set(self.state["loss"])
                ins["lr"].set(float(lr))
                if "grad_norm" in tele:
                    ins["grad_norm"].set(float(tele["grad_norm"]))
            if self._train_summary is not None:
                self._train_summary.add_scalar(
                    "Loss", self.state["loss"], neval)
                self._train_summary.add_scalar("LearningRate", lr, neval)
            self._pending_loss = None

    def _after_iteration(self, opt_state, state):
        # each trigger is evaluated once a pass (triggers may be
        # stateful); the neval check keeps the epoch-end pass from firing
        # an iteration-cadence trigger again at the same neval
        if self._validation_trigger is not None:
            if getattr(self._validation_trigger, "uses_loss", False):
                self._drain_loss()
            if self._validation_trigger(state) and \
                    getattr(self, "_last_val_neval", -1) != state["neval"]:
                self._last_val_neval = state["neval"]
                self._drain_loss()
                self._run_validation(state)
        if self._checkpoint_trigger is not None:
            if getattr(self._checkpoint_trigger, "uses_loss", False):
                self._drain_loss()
            if self._checkpoint_trigger(state) and \
                    getattr(self, "_last_ckpt_neval", -1) != state["neval"]:
                self._last_ckpt_neval = state["neval"]
                self._drain_loss()
                self._save_checkpoint(opt_state, state)

    def _run_validation(self, state):
        results = validate(self.model, None, None, self._validation_dataset,
                           self._validation_methods, self._validation_batch)
        for method, res in zip(self._validation_methods, results):
            logger.info("Validation @ iter %d: %s = %s",
                        state["neval"], method, res)
            if self._val_summary is not None:
                self._val_summary.add_scalar(
                    str(method), res.result, state["neval"])
        if results:
            state["score"] = results[0].result
            sched = getattr(self.optim_method, "schedule", None)
            if sched is not None and hasattr(sched, "record_score"):
                sched.record_score(results[0].result)

    def _save_checkpoint(self, opt_state, state):
        reliability.inject("optimizer.checkpoint")
        self._write_checkpoint(None, None, opt_state,
                               self.optim_method.get_state(), dict(state),
                               _generator_states(self.model))

    def _write_checkpoint(self, params, states, opt_state, host_state,
                          train_state, rng):
        """Persist one checkpoint pair: the live model's weights when
        ``params`` / ``states`` are ``None``, else those trees (an elastic
        ring entry's; the live module is written with them in place and
        given back its own tensors, the same objects, after)."""
        tag = f"{train_state['epoch']}.{train_state['neval']}"
        # model first, optim second: latest() needs the valid pair
        with _weights_in_place(self.model, params, states):
            self.model.save_module(
                os.path.join(self._checkpoint_path, f"model.{tag}"))
        from bigdl_tpu_torch.utils.checkpoint import (prune_checkpoints,
                                                      save_checkpoint)
        save_checkpoint(
            os.path.join(self._checkpoint_path, f"optim.{tag}"),
            {"opt_state": opt_state,
             "host_state": host_state,
             "train_state": dict(train_state),
             "world": self._world_signature(),
             "rng": rng})
        logger.info("checkpoint saved: %s @ %s", self._checkpoint_path, tag)
        from bigdl_tpu_torch.utils.conf import conf
        keep = conf.get_int("bigdl.checkpoint.keep", 0) or 0
        if keep > 0:
            prune_checkpoints(self._checkpoint_path, keep)

    def _world_signature(self) -> dict:
        """The shard-math identity a checkpoint resumes under: one
        process on one device for the local optimizer."""
        return {"processes": 1, "devices": 1}

    def _check_world(self, saved: Optional[dict], path: str, tag: str):
        """Refuse a checkpoint saved by a different world size or mesh
        shape (the batch math would silently change)."""
        if not saved:
            return
        cur = self._world_signature()
        mismatched = [k for k in ("processes", "devices", "mesh_shape",
                                  "mesh_axes")
                      if k in saved and k in cur and saved[k] != cur[k]]
        if mismatched:
            raise ValueError(
                f"checkpoint {path} @ {tag} was saved by a different "
                f"world: saved {saved}, current {cur} (mismatched: "
                f"{', '.join(mismatched)}); load the weights with "
                "Module.load_weights to retrain under this one")

    def resume_from_checkpoint(self, path: str, tag: str):
        """Resume (ref: Optimizer resume = loadModule + OptimMethod.load):
        the weights load into the live model (it keeps its device and
        identity), the optim slots wait for the next ``optimize()``."""
        from bigdl_tpu_torch.utils.checkpoint import load_checkpoint
        blob, _ = load_checkpoint(os.path.join(path, f"optim.{tag}"))
        self._check_world(blob.get("world"), path, tag)
        self.model.load_weights(os.path.join(path, f"model.{tag}"))
        _load_generator_states(self.model, blob.get("rng"))
        self.optim_method.load_state(blob["host_state"])
        # a key absent from an older blob must not keep a live value
        self.state["batch_in_epoch"] = 0
        self.state.update(blob["train_state"])
        self.state["epoch_finished"] = False
        self._resume_opt_state = blob["opt_state"]
        return self


class LocalOptimizer(BaseOptimizer):
    """Single-device training (ref: LocalOptimizer.scala — its per-core
    model clones are unnecessary: one step fills the card)."""


class DistriOptimizer(BaseOptimizer):
    """Mesh data-parallel training (ref: DistriOptimizer.scala), over the
    Engine's mesh (or ``mesh``) along ``data_axis``: see the module
    docstring. ``device=None`` is the GPU under NCCL, ``"cpu"`` the host
    under gloo; the Engine is initialised for it when cold. A GPU device
    over a gloo mesh is ranks sharing one card (the collectives stage
    their CUDA tensors through the host); an NCCL mesh refuses a CPU
    device."""

    def __init__(self, model, dataset, criterion, batch_size: int = 32,
                 end_trigger=None, mesh=None, data_axis: str = "data",
                 device=None):
        dev = resolve_device(device)
        if mesh is None:
            if not Engine.is_initialized():
                Engine.init(engine_type="cpu" if dev.type == "cpu"
                            else "gpu")
            mesh = Engine.mesh()
        # a gloo mesh may hold CUDA tensors (ranks sharing one card: the
        # collectives stage through the host); NCCL holds only CUDA ones
        if mesh.device_type != dev.type and not (
                mesh.device_type == "cpu" and dev.type == "cuda"):
            raise ValueError(f"DistriOptimizer on {dev} needs a mesh of "
                             f"{dev.type} devices; the mesh is on "
                             f"{mesh.device_type}")
        names = mesh.mesh_dim_names or ()
        if data_axis not in names:
            raise ValueError(f"the mesh's axes {names} lack the data axis "
                             f"{data_axis!r}")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        super().__init__(model, dataset, criterion, batch_size, end_trigger,
                         device=dev)
        self.mesh = mesh
        self.data_axis = data_axis
        self._n_data = mesh.size(names.index(data_axis))
        self._group = mesh.get_group(data_axis)
        self._grad_compression: Optional[str] = None
        if batch_size % self._n_data != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by data-parallel "
                f"degree {self._n_data} (ref requires batch % nodes == 0 "
                "too)")

    def set_gradient_compression(self, mode: Optional[str]):
        """Wire-compress the gradient all-reduce (ref: AllReduceParameter's
        FP16CompressedTensor): ``"bf16"`` / ``"fp16"`` sum in bf16
        (``compressed_all_reduce``), ``"int8"`` the shared-scale int8
        all-reduce (``quantized_all_reduce``), ``None`` a plain f32 sum.
        A compressed step normalises each rank's own shard and averages
        the float states after it, as the JAX ``shard_map`` step does."""
        if mode not in (None, "bf16", "fp16", "int8"):
            raise ValueError(f"unknown gradient compression {mode!r}")
        self._grad_compression = mode
        return self

    def _per_rank_data(self) -> bool:
        ds = self.dataset
        while ds is not None:
            if isinstance(ds, DistributedDataSet):
                return True
            ds = getattr(ds, "parent", None)
        return False

    def _batcher(self):
        if self._per_rank_data():
            return SampleToMiniBatch(self.batch_size // self._n_data)
        return SampleToMiniBatch(self.batch_size)

    def _place_batch(self, x, t):
        if not self._per_rank_data():
            from bigdl_tpu_torch.parallel.mesh import shard_batch
            x, t = shard_batch([x, t], self.mesh, self.data_axis)
        return super()._place_batch(x, t)

    def _forward_context(self):
        if self._grad_compression is None and self._n_data > 1:
            from bigdl_tpu_torch.parallel.collectives import \
                global_batch_stats
            return global_batch_stats(self._group)
        return contextlib.nullcontext()

    def _reduce(self, loss, grads):
        """Average the gradients (in the wire format of the compression
        mode) and the loss over the data group; under compression, also
        average the float states (the running statistics)."""
        from bigdl_tpu_torch.parallel import collectives as col
        mode, g = self._grad_compression, self._group
        if mode == "int8":
            grads = col.quantized_all_reduce(grads, g, mean=True)
        elif mode:
            grads = col.compressed_all_reduce(grads, g, mean=True)
        else:
            grads = col.all_reduce(grads, g, mean=True)
        loss = col.all_reduce(loss, g, mean=True)
        if mode:
            bufs = [b for b in self.model.buffers() if b.is_floating_point()]
            if bufs:
                with torch.no_grad():
                    torch._foreach_copy_(bufs, col.all_reduce(bufs, g,
                                                              mean=True))
        return loss, grads

    def _world_signature(self) -> dict:
        import torch.distributed as dist
        world = dist.get_world_size()
        return {"processes": world, "devices": world,
                "mesh_shape": [int(d) for d in self.mesh.shape],
                "mesh_axes": list(self.mesh.mesh_dim_names or ())}

    def _save_checkpoint(self, opt_state, state):
        """Rank 0 writes (the state is the same on every rank; the
        directory must be shared); every rank waits for it."""
        import torch.distributed as dist
        if dist.get_rank() == 0:
            super()._save_checkpoint(opt_state, state)
        dist.barrier()


class Optimizer:
    """Facade (ref: Optimizer.apply): ``distributed`` defaults to an
    initialised Engine with a world above one."""

    def __new__(cls, model: Module, dataset, criterion,
                batch_size: int = 32, end_trigger=None,
                distributed: Optional[bool] = None, device=None, **kwargs):
        if distributed is None:
            distributed = Engine.is_initialized() and \
                Engine.world_size() > 1
        if distributed:
            return DistriOptimizer(model, dataset, criterion, batch_size,
                                   end_trigger, device=device, **kwargs)
        return LocalOptimizer(model, dataset, criterion, batch_size,
                              end_trigger, device=device)


# ---------------------------------------------------------------------------
# Evaluation / prediction (ref: optim/Evaluator.scala, Predictor.scala)
# ---------------------------------------------------------------------------

def _eval_batches(model, dataset, batch_size):
    """Eval-mode forwards over ``dataset`` in order: ``(output,
    minibatch)`` pairs; the model's mode is put back after."""
    if isinstance(dataset, tuple):
        dataset = LocalDataSet(*dataset, shuffle=False)
    elif isinstance(dataset, np.ndarray):
        dataset = LocalDataSet(dataset, shuffle=False)
    dev = _module_device(model)
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            batcher = SampleToMiniBatch(batch_size, drop_remainder=False)
            for mb in batcher(dataset.data(train=False)):
                yield model(_to_dev(mb.get_input(), dev)), mb
    finally:
        model.train(was)


def validate(model: Module, params, states, dataset,
             methods: Sequence[ValidationMethod], batch_size: int = 32):
    """Eval-mode forward over the dataset, each method's results merged
    across batches (ref: Evaluator.scala). ``params`` / ``states``, when
    given, are loaded into the model first; ``None`` keeps its own."""
    if params is not None:
        model.load_parameters_dict(params)
    if states is not None:
        model.load_states_dict(states)
    results = [None] * len(methods)
    for y, mb in _eval_batches(model, dataset, batch_size):
        for i, m in enumerate(methods):
            r = m(y, mb.get_target())
            results[i] = r if results[i] is None else results[i].merge(r)
    return results


class Evaluator:
    def __init__(self, model: Module, device=None):
        self.model = model.to(resolve_device(device))

    def evaluate(self, dataset, methods: Sequence[ValidationMethod],
                 batch_size: int = 32):
        return validate(self.model, None, None, dataset, methods,
                        batch_size)


class Predictor:
    def __init__(self, model: Module, batch_size: int = 32, device=None):
        self.model = model.to(resolve_device(device))
        self.batch_size = batch_size

    def predict(self, dataset):
        return np.concatenate([to_numpy(y) for y, _ in _eval_batches(
            self.model, dataset, self.batch_size)], axis=0)

    def predict_class(self, dataset):
        return self.predict(dataset).argmax(axis=-1) + 1  # 1-based parity

"""AutoEstimator — the port of ``bigdl_tpu/orca/automl/auto_estimator.py``
(ref: P:orca/automl/auto_estimator.py — HPO driver that Ray-Tunes a
model_creator over a search space, with the same creator-function
contract).

Trials run serially, in parallel across a
:class:`~bigdl_tpu_torch.orca.ray_pool.RayContext` worker pool (the
RayOnSpark execution shape), or under an ASHA-style successive-halving
scheduler (``scheduler="asha"``): every config gets ``grace_epochs``,
only the top ``1/reduction_factor`` advance to the next rung with
``reduction_factor×`` the budget, repeated until one rung fits within
``epochs`` — Ray Tune's default scheduler lineage. The configs, their
order, the scores and the record-once rule are the JAX package's.

The pool carries tasks by the standard library's ``pickle``, which
carries functions by reference: a pool trial is the module-level
:func:`_trial` bound with ``functools.partial`` to the builder, the data
and the budget, so the builder must be a module-level callable (a
class, a function). A lambda or a closure raises
:class:`~bigdl_tpu_torch.orca.ray_pool.TaskNotPicklable` in the parent
before anything is sent.
"""

from __future__ import annotations

import functools
import itertools
import logging
import random
from typing import Callable, Optional

from bigdl_tpu_torch.orca.automl.hp import grid_axes, sample_config

logger = logging.getLogger("bigdl_tpu_torch.orca.automl")


def _trial(builder, data, val, epochs, batch_size, metric, cfg) -> float:
    """One pool trial: build, fit, score (runs in a spawned worker)."""
    model = builder(dict(cfg))
    model.fit(data, epochs=epochs, batch_size=batch_size)
    return float(model.evaluate(val, metrics=[metric])[0])


class AutoEstimator:
    def __init__(self, model_builder: Callable[[dict], object],
                 metric: str = "mse", mode: str = "min"):
        """model_builder(config) -> object with fit(data, ...) and
        evaluate(data, metrics=[metric]) -> [value]."""
        self.model_builder = model_builder
        self.metric = metric
        self.mode = mode
        self.best_config: Optional[dict] = None
        self.best_model = None
        self.best_score: Optional[float] = None
        self.trials = []

    def fit(self, data, validation_data=None, search_space: dict = None,
            n_sampling: int = 8, epochs: int = 3, batch_size: int = 32,
            seed: int = 0, ray_ctx=None, scheduler: Optional[str] = None,
            grace_epochs: int = 1, reduction_factor: int = 2):
        rng = random.Random(seed)
        grids = grid_axes(search_space)
        if grids:
            grid_values = [search_space[k].options for k in grids]
            configs = []
            for combo in itertools.product(*grid_values):
                cfg = sample_config(
                    {k: v for k, v in search_space.items()
                     if k not in grids}, rng)
                cfg.update(dict(zip(grids, combo)))
                configs.append(cfg)
        else:
            configs = [sample_config(search_space, rng)
                       for _ in range(n_sampling)]

        val = validation_data if validation_data is not None else data
        if scheduler == "asha":
            if ray_ctx is not None:
                logger.warning(
                    "scheduler='asha' runs trials serially (rung models "
                    "keep incremental state in-driver); ray_ctx is "
                    "ignored — drop the scheduler for pool-parallel "
                    "trials")
            self._fit_asha(configs, data, val, epochs, batch_size,
                           grace_epochs, reduction_factor)
        elif ray_ctx is not None:
            self._fit_parallel(configs, data, val, epochs, batch_size,
                               ray_ctx)
        else:
            self._fit_serial(configs, data, val, epochs, batch_size)
        return self

    def _better(self):
        return (lambda a, b: a < b) if self.mode == "min" \
            else (lambda a, b: a > b)

    def _record(self, cfg, score, model=None):
        self.trials.append({"config": cfg, self.metric: score})
        better = self._better()
        if self.best_score is None or better(score, self.best_score):
            self.best_score = score
            self.best_config = cfg
            if model is not None:
                self.best_model = model

    def _fit_serial(self, configs, data, val, epochs, batch_size):
        for i, cfg in enumerate(configs):
            model = self.model_builder(dict(cfg))
            model.fit(data, epochs=epochs, batch_size=batch_size)
            score = float(model.evaluate(val, metrics=[self.metric])[0])
            logger.info("trial %d/%d %s=%.6f %s", i + 1, len(configs),
                        self.metric, score, cfg)
            self._record(cfg, score, model)

    def _fit_parallel(self, configs, data, val, epochs, batch_size,
                      ray_ctx):
        """One trial per pool task (Ray-Tune shape: workers return
        scores, not models; the winner retrains in-driver so
        get_best_model() keeps its contract)."""
        from bigdl_tpu_torch.orca.ray_pool import _check_carriable
        _check_carriable(self.model_builder)
        task = functools.partial(_trial, self.model_builder, data, val,
                                 epochs, batch_size, self.metric)
        scores = ray_ctx.map(task, configs)
        for cfg, score in zip(configs, scores):
            self._record(cfg, score)
        best = self.model_builder(dict(self.best_config))
        best.fit(data, epochs=epochs, batch_size=batch_size)
        self.best_model = best

    def _fit_asha(self, configs, data, val, epochs, batch_size,
                  grace_epochs, reduction_factor):
        """Successive halving: rung budgets grow by reduction_factor,
        survivors are the top 1/reduction_factor of each rung. Models
        keep training incrementally (fit() continues on the same
        object), so total epochs spent is far below len(configs) *
        epochs."""
        live = [(dict(cfg), self.model_builder(dict(cfg)), 0)
                for cfg in configs]
        budget = grace_epochs
        rung = 0
        while live:
            scored = []
            for cfg, model, done in live:
                add = min(budget, epochs) - done
                if add > 0:
                    model.fit(data, epochs=add, batch_size=batch_size)
                score = float(model.evaluate(
                    val, metrics=[self.metric])[0])
                scored.append((score, cfg, model, min(budget, epochs)))
            scored.sort(key=lambda t: t[0],
                        reverse=(self.mode == "max"))
            logger.info("asha rung %d (budget %d): %d trials, best "
                        "%s=%.6f", rung, min(budget, epochs),
                        len(scored), self.metric, scored[0][0])
            # a trial is recorded exactly ONCE, at its FINAL evaluation
            # (elimination or last rung): recording every rung would let
            # best_model be captured early and then mutated by later
            # incremental fit() calls, and duplicate trials entries
            if budget >= epochs or len(scored) == 1:
                for score, cfg, model, done in scored:
                    self._record(cfg, score, model)
                break
            keep = max(1, len(scored) // reduction_factor)
            for score, cfg, model, done in scored[keep:]:
                self._record(cfg, score, model)   # eliminated: final state
            live = [(cfg, model, done)
                    for score, cfg, model, done in scored[:keep]]
            budget *= reduction_factor
            rung += 1

    def get_best_model(self):
        return self.best_model

    def get_best_config(self) -> dict:
        return self.best_config

"""OptimMethods and learning-rate schedules — the port of
``bigdl_tpu/optim/optim_method.py`` (ref: .../optim/SGD.scala, Adam.scala,
AdamWeightDecay.scala, Adagrad.scala, RMSprop.scala, Ftrl.scala, LBFGS.scala
and SGD.scala's LearningRateSchedule hierarchy).

Each method is the JAX package's pair ``init_state(params)`` /
``step(params, grads, state, lr)`` on nested dicts of tensors, written
as the JAX rules are (out of place, leaf by leaf), not ``torch.optim``:
the state trees keep the JAX keys (``velocity``, ``m`` / ``v`` / ``t``,
``accum``, ...), so they checkpoint key for key. Two JAX conventions
differ from torch's: SGD's ``dampening`` defaults to ``momentum`` (torch:
0), and ``Default`` divides the rate by ``1 + eval_counter *
learning_rate_decay``. The learning rate comes from the schedule on the
host each iteration and enters the step as a Python float.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from bigdl_tpu_torch.utils.tree import tree_leaves, tree_map, \
    tree_unflatten


# ---------------------------------------------------------------------------
# Learning-rate schedules (host-side)
# ---------------------------------------------------------------------------

class LearningRateSchedule:
    def lr(self, base_lr: float, state: Dict[str, Any]) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """ref: SGD.Default — lr / (1 + n*decay)."""

    def lr(self, base_lr, state):
        return base_lr / (1 + state["eval_counter"]
                          * state.get("learning_rate_decay", 0.0))


class Step(LearningRateSchedule):
    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def lr(self, base_lr, state):
        return base_lr * self.gamma ** (state["eval_counter"] // self.step_size)


class MultiStep(LearningRateSchedule):
    def __init__(self, step_sizes, gamma: float):
        self.step_sizes, self.gamma = list(step_sizes), gamma

    def lr(self, base_lr, state):
        n = state["eval_counter"]
        return base_lr * self.gamma ** sum(1 for s in self.step_sizes
                                           if n >= s)


class Exponential(LearningRateSchedule):
    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False):
        self.decay_step, self.decay_rate = decay_step, decay_rate
        self.stair_case = stair_case

    def lr(self, base_lr, state):
        n = state["eval_counter"] / self.decay_step
        if self.stair_case:
            n = math.floor(n)
        return base_lr * self.decay_rate ** n


class Poly(LearningRateSchedule):
    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def lr(self, base_lr, state):
        n = min(state["eval_counter"], self.max_iteration)
        return base_lr * (1 - n / self.max_iteration) ** self.power


class Warmup(LearningRateSchedule):
    """Linear warmup by delta per iteration (ref: SGD.Warmup)."""

    def __init__(self, delta: float):
        self.delta = delta

    def lr(self, base_lr, state):
        return base_lr + self.delta * state["eval_counter"]


class Plateau(LearningRateSchedule):
    """Reduce on validation-score plateau (ref: SGD.Plateau). The Optimizer
    feeds scores via ``record_score``."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0):
        self.factor, self.patience = factor, patience
        self.mode, self.epsilon = mode, epsilon
        self.cooldown, self.min_lr = cooldown, min_lr
        self._best: Optional[float] = None
        self._wait = 0
        self._cool = 0
        self._scale = 1.0

    def record_score(self, score: float):
        better = (self._best is None
                  or (self.mode == "min" and score < self._best - self.epsilon)
                  or (self.mode == "max" and score > self._best + self.epsilon))
        if better:
            self._best = score
            self._wait = 0
        elif self._cool > 0:
            self._cool -= 1
        else:
            self._wait += 1
            if self._wait >= self.patience:
                self._scale *= self.factor
                self._wait = 0
                self._cool = self.cooldown

    def lr(self, base_lr, state):
        return max(base_lr * self._scale, self.min_lr)


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for N iterations (ref: SGD.SequentialSchedule)."""

    def __init__(self):
        self.schedules = []  # (schedule, duration)

    def add(self, schedule: LearningRateSchedule, max_iteration: int):
        self.schedules.append((schedule, max_iteration))
        return self

    def lr(self, base_lr, state):
        n = state["eval_counter"]
        offset = 0
        for sched, dur in self.schedules:
            if n < offset + dur or (sched, dur) == self.schedules[-1]:
                return sched.lr(base_lr, dict(state,
                                              eval_counter=n - offset))
            offset += dur
        return base_lr


# ---------------------------------------------------------------------------
# Optim methods
# ---------------------------------------------------------------------------

def _zeros(params):
    return tree_map(torch.zeros_like, params)


class OptimMethod:
    """Base (ref: optim/OptimMethod.scala). ``host_state`` holds the
    iteration counter ``eval_counter`` the schedules read."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None,
                 learning_rate_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.schedule = learning_rate_schedule or Default()
        self.learning_rate_decay = learning_rate_decay
        self.host_state: Dict[str, Any] = {
            "eval_counter": 0, "epoch": 1,
            "learning_rate_decay": learning_rate_decay}

    def current_lr(self) -> float:
        return float(self.schedule.lr(self.learning_rate, self.host_state))

    def init_state(self, params):
        return {}

    def step(self, params, grads, state, lr):
        """Returns ``(new_params, new_state)``."""
        raise NotImplementedError

    def get_state(self):
        return dict(self.host_state)

    def load_state(self, s):
        self.host_state.update(s)
        return self


class SGD(OptimMethod):
    """ref: optim/SGD.scala — momentum, dampening (default: momentum),
    nesterov, weight decay."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, learning_rate_schedule,
                         learning_rate_decay)
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov:
            assert momentum > 0 and self.dampening == 0, \
                "nesterov requires momentum and zero dampening"

    def init_state(self, params):
        return {"velocity": _zeros(params)} if self.momentum > 0 else {}

    def step(self, params, grads, state, lr):
        wd, mom = self.weight_decay, self.momentum
        if wd > 0:
            grads = tree_map(lambda g, p: g + wd * p, grads, params)
        new_state = state
        if mom > 0:
            damp = self.dampening
            vel = tree_map(lambda v, g: mom * v + (1 - damp) * g,
                           state["velocity"], grads)
            grads = tree_map(lambda g, v: g + mom * v, grads, vel) \
                if self.nesterov else vel
            new_state = {"velocity": vel}
        return tree_map(lambda p, g: p - lr * g.to(p.dtype), params,
                        grads), new_state


class Adam(OptimMethod):
    """ref: optim/Adam.scala; bias corrections ``1 - beta ** t`` in f32."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learning_rate, learning_rate_schedule,
                         learning_rate_decay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        dev = tree_leaves(params)[0].device
        return {"m": _zeros(params), "v": _zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def _moments(self, grads, state):
        b1, b2 = self.beta1, self.beta2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                     state["v"], grads)
        return m, v, state["t"] + 1

    def step(self, params, grads, state, lr):
        m, v, t = self._moments(grads, state)
        tf = t.to(torch.float32)
        bc1 = 1 - torch.pow(self.beta1, tf)
        bc2 = 1 - torch.pow(self.beta2, tf)
        eps = self.epsilon
        new = tree_map(lambda p, m_, v_: p - (
            lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}


class AdamWeightDecay(Adam):
    """Decoupled weight decay + warmup / linear decay (ref:
    AdamWeightDecay.scala — the BERT optimizer)."""

    def __init__(self, learning_rate: float = 1e-3, warmup_portion: float = -1.0,
                 total: int = -1, schedule: str = "linear",
                 beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.01):
        super().__init__(learning_rate, 0.0, beta1, beta2, epsilon)
        self.warmup_portion = warmup_portion
        self.total = total
        self.weight_decay = weight_decay
        self.schedule_kind = schedule

    def current_lr(self):
        n = self.host_state["eval_counter"]
        if self.total <= 0:
            return self.learning_rate
        progress = n / self.total
        warm = self.warmup_portion
        if warm > 0 and progress < warm:
            return self.learning_rate * progress / warm
        if self.schedule_kind == "linear":
            return self.learning_rate * max(0.0, 1.0 - progress)
        return self.learning_rate

    def step(self, params, grads, state, lr):
        m, v, t = self._moments(grads, state)
        eps, wd = self.epsilon, self.weight_decay
        new = tree_map(lambda p, m_, v_: p - lr * (
            m_ / (torch.sqrt(v_) + eps) + wd * p).to(p.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}


class Adagrad(OptimMethod):
    """ref: optim/Adagrad.scala."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate, None, learning_rate_decay)
        self.weight_decay = weight_decay

    def init_state(self, params):
        return {"accum": _zeros(params)}

    def step(self, params, grads, state, lr):
        if self.weight_decay > 0:
            grads = tree_map(lambda g, p: g + self.weight_decay * p,
                             grads, params)
        accum = tree_map(lambda a, g: a + g * g, state["accum"], grads)
        new = tree_map(lambda p, g, a: p - (
            lr * g / (torch.sqrt(a) + 1e-10)).to(p.dtype),
            params, grads, accum)
        return new, {"accum": accum}


class RMSprop(OptimMethod):
    """ref: optim/RMSprop.scala."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0,
                 decay_rate: float = 0.99, epsilon: float = 1e-8):
        super().__init__(learning_rate, None, learning_rate_decay)
        self.decay_rate, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        return {"sq": _zeros(params)}

    def step(self, params, grads, state, lr):
        dr, eps = self.decay_rate, self.epsilon
        sq = tree_map(lambda s, g: dr * s + (1 - dr) * g * g,
                      state["sq"], grads)
        new = tree_map(lambda p, g, s: p - (
            lr * g / (torch.sqrt(s) + eps)).to(p.dtype), params, grads, sq)
        return new, {"sq": sq}


class Adadelta(OptimMethod):
    """ref: optim/Adadelta.scala."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        super().__init__(1.0, None, 0.0)
        self.decay_rate, self.epsilon = decay_rate, epsilon

    def init_state(self, params):
        return {"sq": _zeros(params), "delta": _zeros(params)}

    def step(self, params, grads, state, lr):
        rho, eps = self.decay_rate, self.epsilon
        sq = tree_map(lambda s, g: rho * s + (1 - rho) * g * g,
                      state["sq"], grads)
        upd = tree_map(lambda g, s, d: g * torch.sqrt(d + eps)
                       / torch.sqrt(s + eps), grads, sq, state["delta"])
        delta = tree_map(lambda d, u: rho * d + (1 - rho) * u * u,
                         state["delta"], upd)
        new = tree_map(lambda p, u: p - lr * u.to(p.dtype), params, upd)
        return new, {"sq": sq, "delta": delta}


class Adamax(OptimMethod):
    """ref: optim/Adamax.scala."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__(learning_rate, None, 0.0)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        dev = tree_leaves(params)[0].device
        return {"m": _zeros(params), "u": _zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def step(self, params, grads, state, lr):
        b1, b2 = self.beta1, self.beta2
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        u = tree_map(lambda u_, g: torch.maximum(b2 * u_,
                                                 torch.abs(g) + self.epsilon),
                     state["u"], grads)
        bc = 1 - torch.pow(b1, t.to(torch.float32))
        new = tree_map(lambda p, m_, u_: p - (lr / bc * m_ / u_).to(p.dtype),
                       params, m, u)
        return new, {"m": m, "u": u, "t": t}


class Ftrl(OptimMethod):
    """ref: optim/Ftrl.scala — follow-the-regularized-leader."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0):
        super().__init__(learning_rate, None, 0.0)
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength

    def init_state(self, params):
        return {"accum": tree_map(
                    lambda p: torch.full_like(p, self.init_accum), params),
                "linear": _zeros(params)}

    def step(self, params, grads, state, lr):
        lp, l1, l2 = self.lr_power, self.l1, self.l2

        def upd(p, g, n, z):
            n_new = n + g * g
            sigma = (n_new ** -lp - n ** -lp) / lr
            z_new = z + g - sigma * p
            p_new = torch.where(
                torch.abs(z_new) <= l1, torch.zeros_like(p),
                -(z_new - torch.sign(z_new) * l1)
                / (n_new ** -lp / lr + 2 * l2))
            return p_new, n_new, z_new

        out = [upd(*a) for a in zip(*(tree_leaves(t) for t in (
            params, grads, state["accum"], state["linear"])))]
        new_p, new_n, new_z = ([o[i] for o in out] for i in range(3))
        return tree_unflatten(params, new_p), {
            "accum": tree_unflatten(params, new_n),
            "linear": tree_unflatten(params, new_z)}


class LBFGS(OptimMethod):
    """Limited-memory BFGS (ref: optim/LBFGS.scala), the JAX package's
    formulation: curvature pairs (s, y) in fixed ring buffers over the
    flattened parameter vector, the two-loop recursion, a fixed step
    ``p -= lr * direction``; the first step is torch-lbfgs's damped
    gradient step."""

    def __init__(self, learning_rate: float = 1.0, history_size: int = 5,
                 learning_rate_schedule: Optional[LearningRateSchedule]
                 = None):
        super().__init__(learning_rate, learning_rate_schedule)
        self.m = history_size

    @staticmethod
    def _ravel(tree):
        return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])

    def init_state(self, params):
        flat = self._ravel(params)
        d = flat.shape[0]
        z = lambda *s: torch.zeros(s, dtype=flat.dtype,  # noqa: E731
                                   device=flat.device)
        return {"s": z(self.m, d), "y": z(self.m, d), "rho": z(self.m),
                "prev_p": z(d), "prev_g": z(d),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=flat.device)}

    def step(self, params, grads, state, lr):
        flat_g, flat_p = self._ravel(grads), self._ravel(params)
        m = self.m
        first = int(state["count"]) == 0
        if not first:
            sv = flat_p - state["prev_p"]
            yv = flat_g - state["prev_g"]
            sy = torch.dot(sv, yv)
            rho = torch.where(sy > 1e-10, 1.0 / torch.clamp(sy, min=1e-10),
                              torch.zeros_like(sy))

            def push(buf, v):
                return torch.cat([buf[1:], v.reshape((1,) + buf.shape[1:])])

            state = {**state, "s": push(state["s"], sv),
                     "y": push(state["y"], yv),
                     "rho": push(state["rho"], rho)}
        q = flat_g
        alphas = []
        for i in range(m - 1, -1, -1):
            a = state["rho"][i] * torch.dot(state["s"][i], q)
            q = q - a * state["y"][i]
            alphas.append((i, a))
        yy = torch.dot(state["y"][-1], state["y"][-1])
        sy = torch.dot(state["s"][-1], state["y"][-1])
        gamma = torch.where((yy > 1e-10) & (sy > 1e-10),
                            sy / torch.clamp(yy, min=1e-10),
                            torch.ones_like(yy))
        r = gamma * q
        for i, a in reversed(alphas):
            beta = state["rho"][i] * torch.dot(state["y"][i], r)
            r = r + state["s"][i] * (a - beta)
        if first:
            g_l1 = torch.abs(flat_g).sum()
            r = flat_g * torch.clamp(1.0 / torch.clamp(g_l1, min=1e-12),
                                     max=1.0)
        new_flat = flat_p - lr * r
        leaves, out, i = tree_leaves(params), [], 0
        for p in leaves:
            out.append(new_flat[i:i + p.numel()].reshape(p.shape))
            i += p.numel()
        return tree_unflatten(params, out), {
            **state, "prev_p": flat_p, "prev_g": flat_g,
            "count": state["count"] + 1}


# Intra-node parallel Adam (ref: optim/ParallelAdam.scala) is Adam here.
ParallelAdam = Adam

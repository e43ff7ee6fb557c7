"""Triggers — the port of ``bigdl_tpu/optim/trigger.py`` (ref:
.../optim/Trigger.scala): decide when to stop training,
checkpoint, or validate, based on the host-side training state dict
(keys: epoch, neval, loss, score, record_count...).
"""

from __future__ import annotations


class Trigger:
    # True when the trigger reads state["loss"]: the optimizer keeps loss on
    # device (one-step-lagged) unless a trigger needs it synchronously
    uses_loss = False

    def __call__(self, state: dict) -> bool:
        raise NotImplementedError

    @staticmethod
    def every_epoch():
        return _EveryEpoch()

    @staticmethod
    def several_iteration(n: int):
        return _SeveralIteration(n)

    @staticmethod
    def max_epoch(n: int):
        return _MaxEpoch(n)

    @staticmethod
    def max_iteration(n: int):
        return _MaxIteration(n)

    @staticmethod
    def max_score(s: float):
        return _MaxScore(s)

    @staticmethod
    def min_loss(l: float):
        return _MinLoss(l)

    @staticmethod
    def and_(*triggers):
        return _And(triggers)

    @staticmethod
    def or_(*triggers):
        return _Or(triggers)


class _EveryEpoch(Trigger):
    def __init__(self):
        self._last = -1

    def __call__(self, state):
        # fires when the epoch counter has advanced past the last fire
        if state.get("epoch_finished", False) or \
                (self._last >= 0 and state["epoch"] != self._last):
            self._last = state["epoch"]
            return True
        if self._last < 0:
            self._last = state["epoch"]
        return False


class _SeveralIteration(Trigger):
    def __init__(self, n):
        self.n = n

    def __call__(self, state):
        done = state.get("iteration_done", state["neval"] - 1)
        return done > 0 and done % self.n == 0


class _MaxEpoch(Trigger):
    def __init__(self, n):
        self.n = n

    def __call__(self, state):
        return state["epoch"] > self.n


class _MaxIteration(Trigger):
    def __init__(self, n):
        self.n = n

    def __call__(self, state):
        # counts COMPLETED iterations: max_iteration(n) runs exactly n steps
        done = state.get("iteration_done", state["neval"] - 1)
        return done >= self.n


class _MaxScore(Trigger):
    def __init__(self, s):
        self.s = s

    def __call__(self, state):
        return state.get("score", float("-inf")) > self.s


class _MinLoss(Trigger):
    uses_loss = True

    def __init__(self, l):
        self.l = l

    def __call__(self, state):
        return state.get("loss", float("inf")) < self.l


class _And(Trigger):
    def __init__(self, triggers):
        self.triggers = triggers
        self.uses_loss = any(getattr(t, "uses_loss", False) for t in triggers)

    def __call__(self, state):
        return all(t(state) for t in self.triggers)


class _Or(Trigger):
    def __init__(self, triggers):
        self.triggers = triggers
        self.uses_loss = any(getattr(t, "uses_loss", False) for t in triggers)

    def __call__(self, state):
        return any(t(state) for t in self.triggers)

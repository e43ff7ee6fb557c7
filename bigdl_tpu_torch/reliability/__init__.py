"""Reliability layer of the port — ``bigdl_tpu/reliability`` on torch.

- :mod:`~bigdl_tpu_torch.reliability.faults` — named **fault-injection
  points** (``reliability.inject("llm.step")``) threaded through the
  serving engine, its prefix cache and host tier. Zero-cost no-ops in
  production (one attribute check); under a seeded :class:`FaultPlan`
  they deterministically raise, delay or corrupt, at the same calls as
  in the JAX package.
- :mod:`~bigdl_tpu_torch.reliability.policies` — the primitives the real
  paths compose: :class:`RetryPolicy` (exponential backoff + jitter +
  budget), :class:`Deadline` (propagated per-request),
  :class:`CircuitBreaker`, and the health-check registry behind
  ``GET /healthz``.

Every retry / shed / breaker trip / injected fault increments a
``bigdl_reliability_*`` counter in the port's observability registry.

Master switch: ``bigdl.reliability.enabled`` (env
``BIGDL_TPU_RELIABILITY_ENABLED``). Disabled means structurally absent:
no plan can be armed and no health checks register. The switch and the
armed plan are the port's own, apart from the JAX package's.
"""

from __future__ import annotations

from bigdl_tpu_torch.reliability import _state
from bigdl_tpu_torch.reliability.faults import (
    SITES, FaultPlan, InjectedFault, active_plan, armed_sites, inject,
    set_plan)
from bigdl_tpu_torch.reliability.policies import (
    DEADLINE_HEADER, CircuitBreaker, CircuitOpenError, Deadline,
    DeadlineExceeded, OverloadError, RetryPolicy, TrainingPreempted,
    health_checks, health_report, register_health, retry_after_seconds,
    unregister_health)


def enabled() -> bool:
    return _state.enabled


def enable():
    _state.enabled = True


def disable():
    """Structural no-op mode: disarms any plan; subsequent set_plan /
    register_health calls are rejected / ignored."""
    _state.enabled = False
    _state.plan = None


def count_shed(component: str, request_id=None, trace_id=None, **detail):
    """Record one load-shedding rejection (503 + Retry-After). Every
    increment also lands one flight-recorder ``shed`` event (when that
    recorder is enabled) carrying the caller's ledger snapshot — the
    chaos cross-check asserts events reconcile EXACTLY with this
    counter, so the two must share a call site."""
    from bigdl_tpu_torch.reliability.policies import _count
    _count("bigdl_reliability_shed_total",
           "Requests rejected by admission control",
           component=component)
    from bigdl_tpu_torch.observability import flight
    flight.record("shed", request_id=request_id, trace_id=trace_id,
                  component=component, **detail)


__all__ = [
    "DEADLINE_HEADER", "SITES",
    "CircuitBreaker", "CircuitOpenError", "Deadline", "DeadlineExceeded",
    "FaultPlan", "InjectedFault", "OverloadError", "RetryPolicy",
    "TrainingPreempted",
    "active_plan", "armed_sites", "count_shed", "disable", "enable",
    "enabled", "health_checks", "health_report", "inject",
    "register_health", "retry_after_seconds", "set_plan",
    "unregister_health",
]

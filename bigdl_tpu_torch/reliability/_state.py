"""Process-global reliability switches.

The port's copy of ``bigdl_tpu/reliability/_state.py``; mirrors
``bigdl_tpu_torch.observability._state``: a bare module holding the
flags the hot paths read, living apart from the package ``__init__`` so
``faults``/``policies`` and the package itself can all import it without
cycles.

Two attributes matter:

- ``enabled`` — the master switch (config key
  ``bigdl.reliability.enabled``, env ``BIGDL_TPU_RELIABILITY_ENABLED``).
  When False: no fault plan can be armed, no health checks register — the reliability layer is
  structurally absent, not merely quiet.
- ``plan`` — the armed :class:`~bigdl_tpu_torch.reliability.faults.FaultPlan`,
  or ``None`` in production. ``inject(site)``'s fast path is a single
  attribute check (``_state.plan is None``) so production code pays one
  dict lookup + one identity compare per injection point — the
  zero-overhead contract the disabled-mode test asserts.
"""

from __future__ import annotations

from typing import Optional


def _initial() -> bool:
    try:
        from bigdl_tpu_torch.utils.conf import conf
        return conf.get_bool("bigdl.reliability.enabled", True)
    except Exception:
        return True


enabled: bool = _initial()

#: The armed fault plan. None in production — inject() early-returns.
plan = None  # type: Optional[object]


def refresh(key: str):
    """Re-read ONE reliability config key; called by ``BigDLConf.set``/
    ``unset`` so the programmatic layer works after import. Only the
    changed key is applied (a retry-knob change must not clobber a
    runtime ``enable()``/``disable()`` override of the switch)."""
    global enabled, plan
    from bigdl_tpu_torch.utils.conf import conf
    if key == "bigdl.reliability.enabled":
        enabled = conf.get_bool("bigdl.reliability.enabled", True)
        if not enabled:
            plan = None   # disabling disarms any active plan

"""Process-global observability switch of the port (the JAX package's
``observability/_state.py``; the two packages' switches are separate).

Lives in its own module so ``metrics``/``tracing`` and the package
``__init__`` can all read it without import cycles. Hot paths read the
bare module attribute (one dict lookup) — cheap enough for per-token
loops, and exactly zero state is touched when it is False.

Default comes from the layered config (``bigdl.observability.enabled``,
env ``BIGDL_TPU_OBSERVABILITY_ENABLED``); :func:`bigdl_tpu_torch.observability.
enable`/``disable`` override at runtime.
"""

from __future__ import annotations


def _initial() -> bool:
    try:
        from bigdl_tpu_torch.utils.conf import conf
        return conf.get_bool("bigdl.observability.enabled", True)
    except Exception:
        return True


enabled: bool = _initial()


def refresh(key: str):
    """Re-read ONE observability config key. Called by
    ``BigDLConf.set``/``unset`` when a ``bigdl.observability.*`` key
    changes, so the programmatic config layer works after import (the
    hot paths keep reading a bare module attribute). Only the changed
    key is applied — touching the capacity must not clobber a runtime
    ``enable()``/``disable()`` override of the switch."""
    global enabled
    import sys

    from bigdl_tpu_torch.utils.conf import conf
    if key == "bigdl.observability.enabled":
        enabled = conf.get_bool("bigdl.observability.enabled", True)
    elif key == "bigdl.observability.trace.capacity":
        tracing = sys.modules.get("bigdl_tpu_torch.observability.tracing")
        if tracing is not None:
            cap = conf.get_int("bigdl.observability.trace.capacity",
                               65536)
            if cap != tracing.TRACE.capacity:
                tracing.TRACE.set_capacity(cap)
    elif key == "bigdl.observability.exemplars":
        tracing = sys.modules.get("bigdl_tpu_torch.observability.tracing")
        if tracing is not None:
            tracing.EXEMPLARS.capacity = conf.get_int(
                "bigdl.observability.exemplars", 8)
    elif key == "bigdl.observability.flight.enabled":
        flight = sys.modules.get("bigdl_tpu_torch.observability.flight")
        if flight is not None:
            flight.enabled = conf.get_bool(
                "bigdl.observability.flight.enabled", False)
    elif key == "bigdl.observability.flight.capacity":
        flight = sys.modules.get("bigdl_tpu_torch.observability.flight")
        if flight is not None:
            flight.set_capacity(conf.get_int(
                "bigdl.observability.flight.capacity", 4096))
    elif key == "bigdl.observability.timeseries.enabled":
        ts = sys.modules.get("bigdl_tpu_torch.observability.timeseries")
        if ts is not None:
            ts.enabled = conf.get_bool(
                "bigdl.observability.timeseries.enabled", False)
    elif key in ("bigdl.observability.timeseries.interval",
                 "bigdl.observability.timeseries.retention"):
        ts = sys.modules.get("bigdl_tpu_torch.observability.timeseries")
        st = ts.store() if ts is not None else None
        if st is not None:
            st.interval = conf.get_float(
                "bigdl.observability.timeseries.interval", 5.0)
            st.retention = conf.get_float(
                "bigdl.observability.timeseries.retention", 600.0)

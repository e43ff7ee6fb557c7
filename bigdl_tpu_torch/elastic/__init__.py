"""Elastic multi-process training — the port of ``bigdl_tpu/elastic``.

BigDL's reliability claim is that *training* survives worker loss: Spark
reschedules the lost executor and the job completes (arXiv 1804.05839
§4). A multi-process ``DistriOptimizer`` job otherwise hangs in the
gradient all-reduce the moment one peer dies. This package turns that
hang into bounded-time recovery:

- :mod:`~bigdl_tpu_torch.elastic.supervisor` — the coordinator: HTTP
  heartbeat surface, membership, the world state machine, commit
  tracking;
- :mod:`~bigdl_tpu_torch.elastic.agent` — the per-process sidecar: the
  heartbeat thread and the collective-hang watchdog over the optimizer
  loop's per-step heartbeat;
- :mod:`~bigdl_tpu_torch.elastic.snapshot` — the two-tier snapshot
  scheme: an in-RAM ring of the full training state every
  ``bigdl.elastic.snapshot.every`` steps (commit = every live peer has
  it), flushed to the atomic on-disk checkpoints as the durable tier;
- :mod:`~bigdl_tpu_torch.elastic.launch` — the worker-set launcher that
  embeds the supervisor, kills the survivors on failure and respawns a
  new generation that resumes from the last committed snapshot;
- :class:`TrainElastic` — the glue ``BaseOptimizer.optimize`` drives
  (step heartbeat, snapshot cadence, abort checks, durable flushes).

Master switch: ``bigdl.elastic.enabled`` (default **false**). Disabled
means structurally absent: ``optimize()`` never imports this package,
no agent or supervisor thread starts, no ring holds memory, and no
``bigdl_elastic_*`` series is minted.

Same-world-size resume on the CPU is **bit-identical** to an
uninterrupted run: snapshots land on iteration boundaries, the data
pipeline re-skips the batches already consumed in the interrupted
epoch, and the stochastic layers' ``torch.Generator`` states travel in
the snapshot (the JAX package fast-forwards its key chain instead). On
the GPU cuDNN's backward is not bitwise deterministic, so a resumed run
there agrees with an unbroken one only as two unbroken runs agree.
"""

from __future__ import annotations

import copy
import logging
import time

from bigdl_tpu_torch import reliability
from bigdl_tpu_torch.elastic.agent import ElasticAgent
from bigdl_tpu_torch.elastic.snapshot import Snapshot, SnapshotRing, \
    host_copy
from bigdl_tpu_torch.elastic.supervisor import Supervisor

logger = logging.getLogger("bigdl_tpu_torch.elastic")


class ElasticRestart(RuntimeError):
    """A peer died or a collective stalled: abort the step and resume
    from the last committed snapshot. Raised at iteration boundaries by
    the elastic hooks; ``optimize()`` turns it into an in-process
    rollback (ring tier) or a process exit the launcher answers with a
    worker-set restart (durable tier)."""


def enabled() -> bool:
    from bigdl_tpu_torch.utils.conf import conf
    return conf.get_bool("bigdl.elastic.enabled", False)


def _world() -> tuple:
    """``(rank, world size)`` of the live process group, else
    ``(None, 1)``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None, 1


class TrainElastic:
    """Everything ``BaseOptimizer`` needs per elastic run, in one object
    constructed ONLY when ``bigdl.elastic.enabled`` is true."""

    def __init__(self, ring: SnapshotRing, agent: ElasticAgent,
                 every: int, flush_every: int, max_restarts: int):
        self.ring = ring
        self.agent = agent
        self.every = max(1, int(every))
        self.flush_every = int(flush_every)
        self.max_restarts = int(max_restarts)
        self._last_snap_iter = 0
        self._last_flushed_step = -1
        self._last_commit_seen = -1
        self._commits_since_flush = 0
        self._ins = None      # per-run cached instruments (hot loop)

    def _instruments(self):
        """The hot-loop instruments, fetched once a run."""
        from bigdl_tpu_torch import observability as obs
        if self._ins is None:
            self._ins = {
                "age": obs.gauge(
                    "bigdl_elastic_snapshot_age_steps",
                    "Iterations since the last RAM snapshot was taken"),
                "snapshots": obs.counter(
                    "bigdl_elastic_snapshots_total",
                    "RAM snapshots taken into the elastic ring"),
                "flushes": obs.counter(
                    "bigdl_elastic_flushes_total",
                    "Committed snapshots flushed to the durable tier"),
            }
        return self._ins

    @classmethod
    def from_conf(cls) -> "TrainElastic":
        from bigdl_tpu_torch.utils.conf import conf
        addr = conf.get("bigdl.elastic.supervisor.address", "") or ""
        sup_addr = None
        if addr:
            host, _, port = addr.rpartition(":")
            sup_addr = (host or "127.0.0.1", int(port))
        ring = SnapshotRing(
            capacity=conf.get_int("bigdl.elastic.snapshot.ring", 2) or 2,
            # no supervisor -> no peers to wait for: commit at take time
            auto_commit=sup_addr is None)
        rank, _ = _world()
        pid = rank if rank is not None else (
            conf.get_int("bigdl.process.id", 0) or 0)
        agent = ElasticAgent(process_id=pid, ring=ring,
                             supervisor_address=sup_addr)
        return cls(
            ring=ring, agent=agent,
            every=conf.get_int("bigdl.elastic.snapshot.every", 10) or 10,
            flush_every=conf.get_int(
                "bigdl.elastic.snapshot.flush.every", 1) or 0,
            max_restarts=conf.get_int("bigdl.elastic.max.restarts", 3)
            or 0)

    # -- optimizer hooks -----------------------------------------------------
    def start(self) -> "TrainElastic":
        self.agent.start()
        return self

    def close(self):
        self.agent.stop()

    def owns(self, exc: BaseException) -> bool:
        return isinstance(exc, ElasticRestart)

    def process_restart_required(self) -> bool:
        """In-process rollback is only sound when this process IS the
        world: under a supervisor (or any multi-process run) the whole
        worker set restarts together — rejoining a collective solo would
        hang on the peers that are also restarting."""
        if self.agent.has_supervisor:
            return True
        return _world()[1] > 1

    def on_step_begin(self, state: dict):
        """Top of each iteration: the fault site, the step heartbeat, and
        the abort check — a directed or stalled world aborts here, BEFORE
        dispatching into a collective its peers will never join."""
        reliability.inject("elastic.step")
        self.agent.step_heartbeat(state["neval"])
        if self.agent.should_abort():
            raise ElasticRestart(self.agent.abort_reason()
                                 or "elastic abort")

    def on_step_end(self, optimizer, opt_state, state: dict):
        """Iteration-boundary bookkeeping: snapshot at the cadence (the
        live model's params and buffers, the optim slots, the host
        state, the counters and the generators, copied to the host
        before ``take``), advertise it to the supervisor, flush fresh
        commits to the durable tier (process 0)."""
        from bigdl_tpu_torch import observability as obs

        it = int(state.get("iteration_done", 0))
        if obs.enabled():
            self._instruments()["age"].set(it - self._last_snap_iter)
        if it % self.every == 0:
            from bigdl_tpu_torch.optim.optimizer import _generator_states
            optimizer._drain_loss()
            with obs.span("elastic/snapshot", step=state["neval"]):
                model = optimizer.model
                self.ring.take(
                    state["neval"], host_copy(model.parameters_dict()),
                    host_copy(model.states_dict()), host_copy(opt_state),
                    copy.deepcopy(optimizer.optim_method.get_state()),
                    copy.deepcopy(dict(state)),
                    rng=host_copy(_generator_states(model)))
            self._last_snap_iter = it
            self.agent.note_snapshot(state["neval"])
            if obs.enabled():
                self._instruments()["snapshots"].inc()
        self._maybe_flush(optimizer)

    def on_loop_exit(self):
        self.agent.loop_idle()

    # -- the durable tier ----------------------------------------------------
    @staticmethod
    def _process_zero() -> bool:
        rank, _ = _world()
        return rank in (None, 0)

    def _maybe_flush(self, optimizer):
        if self.flush_every <= 0 or not optimizer._checkpoint_path:
            return
        ent = self.ring.newest_committed()
        if ent is None or ent.step <= self._last_flushed_step:
            return
        if ent.step > self._last_commit_seen:
            # count commit-floor ADVANCES, not steps: the same pending
            # entry observed across several iterations is one commit
            self._last_commit_seen = ent.step
            self._commits_since_flush += 1
        if self._commits_since_flush < self.flush_every:
            return
        self._commits_since_flush = 0
        if self._process_zero():
            self.flush(optimizer, ent)
        else:
            # peers advance the cursor without writing: the shared dir
            # gets exactly one writer per committed snapshot
            self._last_flushed_step = ent.step

    def flush(self, optimizer, ent: Snapshot):
        """Persist a committed ring entry as an atomic checkpoint pair —
        the layout ``resume_from_checkpoint`` / auto-resume read."""
        from bigdl_tpu_torch import observability as obs
        with obs.span("elastic/flush", step=ent.step):
            optimizer._write_checkpoint(ent.params, ent.states,
                                        ent.opt_state, ent.host_state,
                                        ent.train_state, ent.rng)
        self._last_flushed_step = ent.step
        if obs.enabled():
            self._instruments()["flushes"].inc()

    def abort_flush(self, optimizer):
        """A survivor's last act before a process-level restart: persist
        the newest committed snapshot so the new generation loses at most
        ``snapshot.every`` steps (process 0 only; a hung process never
        reaches this — the periodic flush covers it)."""
        if not optimizer._checkpoint_path or not self._process_zero():
            return
        ent = self.ring.newest_committed()
        if ent is not None and ent.step > self._last_flushed_step:
            try:
                self.flush(optimizer, ent)
            except Exception as e:   # noqa: BLE001 — best effort on exit
                logger.warning("elastic abort-flush failed: %s", e)

    # -- the ring tier -------------------------------------------------------
    def rollback(self, optimizer) -> bool:
        """Restore the newest committed ring entry into the optimizer
        (True), or report that the caller must fall back to the durable
        tier (False)."""
        from bigdl_tpu_torch import observability as obs
        from bigdl_tpu_torch.optim.optimizer import _load_generator_states
        ent = self.ring.rollback()
        if ent is None:
            return False
        # copies: the entry stays the ring's head for a second rollback,
        # and a CPU model would otherwise train on the entry's storage
        optimizer.model.load_parameters_dict(host_copy(ent.params))
        optimizer.model.load_states_dict(host_copy(ent.states))
        _load_generator_states(optimizer.model, ent.rng)
        optimizer.state.clear()
        optimizer.state.update(copy.deepcopy(ent.train_state))
        optimizer.state["epoch_finished"] = False
        optimizer.optim_method.load_state(copy.deepcopy(ent.host_state))
        optimizer._resume_opt_state = host_copy(ent.opt_state)
        if obs.enabled():
            obs.add_complete("elastic/rollback", time.time(), 0.0,
                             stage="elastic", step=ent.step)
        logger.warning("elastic: rolled back to RAM snapshot @ step %d",
                       ent.step)
        return True

    def on_restart(self):
        """Bookkeeping for one in-process restart."""
        from bigdl_tpu_torch import observability as obs
        self.agent.reset_abort()
        self.agent.loop_idle()
        if obs.enabled():
            obs.counter("bigdl_elastic_restarts_total",
                        "Elastic restarts performed",
                        labelnames=("scope",)
                        ).labels(scope="in_process").inc()


__all__ = [
    "ElasticAgent", "ElasticRestart", "Snapshot", "SnapshotRing",
    "Supervisor", "TrainElastic", "enabled",
]

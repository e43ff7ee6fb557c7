"""Two-tier snapshot scheme for elastic training — the port of
``bigdl_tpu/elastic/snapshot.py``.

The cheap tier is an in-RAM ring of host copies of the full training
state — params, module states (buffers), optimizer slots, the
OptimMethod host state, the driver's ``state`` dict and the stochastic
layers' ``torch.Generator`` states — taken every
``bigdl.elastic.snapshot.every`` steps, at an iteration boundary. The
copies are complete (the device has been read back) before
:meth:`SnapshotRing.take` is called: :func:`host_copy` copies each leaf
synchronously. Rolling back to a ring entry restores that boundary
without touching disk, so an in-process restart costs one device→host
copy per cadence plus a replay of at most ``every`` steps.

The durable tier is the atomic checksummed checkpoint directory:
process 0 flushes the newest **committed** ring entry there (tags
``model.<epoch>.<neval>`` / ``optim.<epoch>.<neval>``, the layout
``BaseOptimizer.resume_from_checkpoint`` reads), so a worker-set
restart resumes from the last committed snapshot although every ring
died with its process.

Commit protocol: a snapshot is *committed* once every live peer has
taken it — the supervisor tracks the minimum reported snapshot step and
hands it back on each heartbeat; the agent calls
:meth:`SnapshotRing.commit`. A single-process (ring-only) run has no
peers to wait for, so ``auto_commit=True`` commits at take time.
Rollback never returns an uncommitted entry: resuming from a snapshot a
dead peer never took would fork the replicas.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import torch


def host_copy(tree):
    """A host copy of a tree of tensors (nested dicts, lists, tuples;
    other leaves kept as they are): every tensor copied to CPU memory of
    its own, so the training step's later in-place or rebound updates do
    not reach it. Returns once the copies hold the values."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def tree_nbytes(tree) -> int:
    """Bytes held by the tensors of a tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return 0


class Snapshot:
    """One committed-or-pending copy of the training state at a step
    boundary. Trees are host tensors (the optimizer moves them back to
    its device on restore); ``rng`` maps a module's index in
    ``model.modules()`` to its generator's state."""

    __slots__ = ("step", "params", "states", "opt_state", "host_state",
                 "train_state", "rng", "committed")

    def __init__(self, step: int, params: Any, states: Any, opt_state: Any,
                 host_state: Dict, train_state: Dict,
                 committed: bool = False, rng: Optional[Dict] = None):
        self.step = int(step)
        self.params = params
        self.states = states
        self.opt_state = opt_state
        self.host_state = host_state
        self.train_state = train_state
        self.rng = rng or {}
        self.committed = committed

    def nbytes(self) -> int:
        return sum(tree_nbytes(t) for t in (
            self.params, self.states, self.opt_state,
            list(self.rng.values())))

    def __repr__(self):
        return (f"Snapshot(step={self.step}, "
                f"committed={self.committed})")


class SnapshotRing:
    """Bounded ring of :class:`Snapshot` entries, newest last.

    ``take`` evicts the oldest entry past ``capacity`` (committed or
    not — the ring bounds RAM, the durable tier bounds loss);
    ``commit(step)`` marks every entry at or below ``step``;
    ``rollback()`` returns the newest committed entry and drops every
    younger (uncommitted) one, so a replay can never observe state the
    surviving peers did not agree on.
    """

    def __init__(self, capacity: int = 2, auto_commit: bool = False):
        self.capacity = max(1, int(capacity))
        self.auto_commit = bool(auto_commit)
        self._lock = threading.Lock()
        self._entries: List[Snapshot] = []
        self.taken = 0
        self.committed = 0
        self.rollbacks = 0

    def take(self, step: int, params: Any, states: Any, opt_state: Any,
             host_state: Dict, train_state: Dict,
             rng: Optional[Dict] = None) -> Snapshot:
        snap = Snapshot(step, params, states, opt_state, host_state,
                        train_state, committed=self.auto_commit, rng=rng)
        with self._lock:
            self._entries.append(snap)
            if len(self._entries) > self.capacity:
                self._entries.pop(0)
            self.taken += 1
            if self.auto_commit:
                self.committed += 1
        return snap

    def commit(self, step: int) -> int:
        """Mark entries with ``entry.step <= step`` committed; returns
        how many flipped (idempotent: re-acking an old committed step
        flips nothing)."""
        flipped = 0
        with self._lock:
            for ent in self._entries:
                if ent.step <= step and not ent.committed:
                    ent.committed = True
                    flipped += 1
            self.committed += flipped
        return flipped

    def newest_committed(self) -> Optional[Snapshot]:
        with self._lock:
            for ent in reversed(self._entries):
                if ent.committed:
                    return ent
        return None

    def newest(self) -> Optional[Snapshot]:
        with self._lock:
            return self._entries[-1] if self._entries else None

    def rollback(self) -> Optional[Snapshot]:
        """Newest committed entry, with every younger entry dropped —
        after a rollback the ring's head is the restore point, so a
        second failure before the next snapshot rolls back to the same
        place instead of replaying uncommitted state. ``None`` when no
        entry is committed (fall back to the durable tier)."""
        with self._lock:
            while self._entries:
                if self._entries[-1].committed:
                    self.rollbacks += 1
                    return self._entries[-1]
                self._entries.pop()
        return None

    def steps(self) -> List[int]:
        with self._lock:
            return [e.step for e in self._entries]

    def committed_steps(self) -> List[int]:
        with self._lock:
            return [e.step for e in self._entries if e.committed]

    def nbytes(self) -> int:
        """Host bytes the ring holds."""
        with self._lock:
            return sum(e.nbytes() for e in self._entries)

    def __len__(self):
        with self._lock:
            return len(self._entries)

"""RayContext — the port of ``bigdl_tpu/orca/ray_pool.py``: the RayOnSpark
role (a multi-process worker pool under one orchestrator dispatching
pickled tasks) on standard-library ``multiprocessing`` spawn workers
(ref: P:orca/ray/raycontext.py).

API shape follows Ray's surface the way the reference uses it::

    ctx = RayContext(num_workers=4).start()
    ref = ctx.remote(fn)(args)        # -> ObjectRef
    ctx.get(ref)                      # block for the result
    ctx.map(fn, items)                # parallel map
    ctx.stop()

Workers are **spawned** (never forked: a forked child would share the
parent's CUDA context). Tasks and results travel by the standard
library's ``pickle`` (the JAX package uses ``cloudpickle``), which
carries module-level functions and classes by reference: a closure, a
lambda, or a function of a ``__main__`` the workers cannot import (a
``python -c`` or stdin program) cannot be carried, and :meth:`remote`'s
call raises :class:`TaskNotPicklable` in the parent before anything is
sent. A task's device is its own business: a CUDA task in a worker opens
its own context on the card.
"""

from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import pickle
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional


def _worker_main(task_q, result_q):
    while True:
        item = task_q.get()
        if item is None:
            return
        task_id, blob = item
        try:
            fn, args, kwargs = pickle.loads(blob)
            out = fn(*args, **kwargs)
            result_q.put((task_id, True, pickle.dumps(out)))
        except BaseException as e:   # noqa: BLE001 — report, don't die
            result_q.put((task_id, False, pickle.dumps(
                (type(e).__name__, str(e), traceback.format_exc()))))


class ObjectRef:
    def __init__(self, task_id: int):
        self.task_id = task_id
        self._event = threading.Event()
        self._ok: Optional[bool] = None
        self._blob: Optional[bytes] = None


class RemoteError(RuntimeError):
    pass


class TaskNotPicklable(TypeError):
    """A task (or an argument) the standard library's ``pickle`` cannot
    carry to a worker."""


def _main_importable() -> bool:
    """Whether spawned workers can import this program's ``__main__``
    (they re-run its file; a ``-c`` / stdin program has none)."""
    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    return path is not None and os.path.exists(path)


def _check_carriable(fn: Callable):
    if getattr(fn, "__module__", None) == "__main__" and \
            not _main_importable():
        raise TaskNotPicklable(
            f"RayContext cannot carry {fn!r}: it is defined in a __main__ "
            "the workers cannot import (a `python -c` or stdin program). "
            "The pool pickles tasks with the standard library, which "
            "carries functions by reference: define the task at module "
            "level in an importable module")


class _RemoteFn:
    def __init__(self, ctx: "RayContext", fn: Callable):
        self._ctx = ctx
        self._fn = fn

    def __call__(self, *args, **kwargs) -> ObjectRef:
        return self._ctx._submit(self._fn, args, kwargs)

    remote = __call__       # ray spelling: f.remote(...)


class RayContext:
    def __init__(self, num_workers: int = 2):
        self.num_workers = num_workers
        self._mp = mp.get_context("spawn")
        self._task_q = self._mp.Queue()
        self._result_q = self._mp.Queue()
        self._procs: List[Any] = []
        self._refs: Dict[int, ObjectRef] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._collector: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "RayContext":
        # spawn children re-import the parent's __main__ from
        # __main__.__file__; a stdin/REPL parent ('<stdin>') has no
        # importable main and the child dies in bootstrap. Hide the
        # phantom path during start (a task from that __main__ is
        # refused at submit).
        main = sys.modules.get("__main__")
        saved = getattr(main, "__file__", None)
        if (main is not None and saved is not None
                and not os.path.exists(saved)):
            del main.__file__
        try:
            for _ in range(self.num_workers):
                p = self._mp.Process(target=_worker_main,
                                     args=(self._task_q, self._result_q),
                                     daemon=True)
                p.start()
                self._procs.append(p)
        finally:
            if saved is not None and not hasattr(main, "__file__"):
                main.__file__ = saved
        self._collector = threading.Thread(target=self._collect,
                                           daemon=True)
        self._collector.start()
        return self

    def stop(self):
        self._stopped.set()
        for _ in self._procs:
            self._task_q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self._procs = []
        if self._collector is not None:
            # exits within its 0.2 s result-queue poll of _stopped
            self._collector.join(timeout=5.0)
            self._collector = None

    def _collect(self):
        while not self._stopped.is_set():
            try:
                task_id, ok, blob = self._result_q.get(timeout=0.2)
            except Exception:        # noqa: BLE001 — queue timeout
                continue
            with self._lock:
                ref = self._refs.pop(task_id, None)
            if ref is not None:
                ref._ok, ref._blob = ok, blob
                ref._event.set()

    # -- task API ------------------------------------------------------------
    def remote(self, fn: Callable) -> _RemoteFn:
        return _RemoteFn(self, fn)

    def _submit(self, fn, args, kwargs) -> ObjectRef:
        if not self._procs:
            raise RuntimeError("RayContext not started")
        _check_carriable(fn)
        try:
            blob = pickle.dumps((fn, args, kwargs))
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TaskNotPicklable(
                f"RayContext cannot carry {fn!r} or its arguments: {e}. "
                "The pool pickles tasks with the standard library, which "
                "carries functions by reference — a closure or a lambda "
                "has no importable name: define the task at module "
                "level") from e
        task_id = next(self._ids)
        ref = ObjectRef(task_id)
        with self._lock:
            self._refs[task_id] = ref
        self._task_q.put((task_id, blob))
        return ref

    def get(self, ref, timeout: Optional[float] = None):
        if isinstance(ref, (list, tuple)):
            return [self.get(r, timeout) for r in ref]
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ref._event.wait(0.5):
            if not any(p.is_alive() for p in self._procs):
                raise RemoteError(
                    f"task {ref.task_id}: every worker of the pool has "
                    "exited (a worker that cannot start — say, a spawned "
                    "child re-running an unguarded __main__ — never "
                    "answers)")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"task {ref.task_id} still running")
        if not ref._ok:
            name, msg, tb = pickle.loads(ref._blob)
            raise RemoteError(f"{name}: {msg}\n--- worker traceback ---\n"
                              f"{tb}")
        return pickle.loads(ref._blob)

    def map(self, fn: Callable, items: Iterable,
            timeout: Optional[float] = None) -> list:
        refs = [self._submit(fn, (it,), {}) for it in items]
        return self.get(refs, timeout)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def init_ray_on_spark(num_workers: int = 2, **_ignored) -> RayContext:
    """Reference-named entry (init_ray_on_spark / RayContext.init)."""
    return RayContext(num_workers).start()

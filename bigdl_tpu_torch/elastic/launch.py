"""Elastic worker-set launcher — the port of ``bigdl_tpu/elastic/launch.py``.

``ElasticLauncher`` owns the process tier of the recovery story: it
embeds a :class:`~bigdl_tpu_torch.elastic.supervisor.Supervisor`, spawns
the ``nprocs`` training processes of generation 0, and monitors three
failure signals — a nonzero worker exit, a supervisor-declared world
failure (heartbeat expiry or a reported stall), and an overall timeout.
On failure it SIGTERMs the survivors (escalating to SIGKILL after a
grace period: a worker wedged in a dead collective never reaches its
signal handler's iteration boundary), bumps the generation, picks a
**fresh** ``torch.distributed`` **coordinator port** (the old store died
with the world) and respawns the full set. The new workers find the
durable snapshot tier on disk and ``optimize()``'s auto-resume replays
from the last committed snapshot at the exact saved iteration.

Workers receive everything through the layered config's environment
names — the JAX launcher's own: ``BIGDL_TPU_ELASTIC_ENABLED``,
``_ELASTIC_SUPERVISOR_ADDRESS``, ``_ELASTIC_GENERATION``,
``BIGDL_TPU_COORDINATOR_ADDRESS``, ``_NUM_PROCESSES`` and
``_PROCESS_ID``, which the port's ``Engine.init`` reads — so any
training script that calls ``Engine.init()`` + ``optimize()`` becomes
elastic unmodified::

    python -m bigdl_tpu_torch.elastic.launch --nprocs 2 -- python train.py

Restart budget: ``bigdl.elastic.max.restarts`` generations beyond the
first; exhausting it raises :class:`ElasticJobFailed` with the tail of
every worker log.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from bigdl_tpu_torch.elastic.supervisor import Supervisor

logger = logging.getLogger("bigdl_tpu_torch.elastic")


class ElasticJobFailed(RuntimeError):
    """The worker set could not be driven to completion within the
    restart budget (or the overall timeout)."""

    def __init__(self, msg: str, log_tails: Optional[Dict[str, str]] = None):
        super().__init__(msg)
        self.log_tails = log_tails or {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ElasticLauncher:
    def __init__(self, worker_argv: List[str], nprocs: int = 2,
                 max_restarts: Optional[int] = None,
                 heartbeat_timeout: Optional[float] = None,
                 poll_interval: float = 0.1,
                 grace: float = 5.0,
                 env: Optional[Dict[str, str]] = None,
                 cwd: Optional[str] = None,
                 log_dir: Optional[str] = None):
        from bigdl_tpu_torch.utils.conf import conf
        self.worker_argv = list(worker_argv)
        self.nprocs = int(nprocs)
        self.max_restarts = (
            max_restarts if max_restarts is not None
            else conf.get_int("bigdl.elastic.max.restarts", 3) or 0)
        self.poll_interval = poll_interval
        self.grace = grace
        self.env = dict(env if env is not None else os.environ)
        self.cwd = cwd
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="bigdl-elastic-")
        self.supervisor = Supervisor(expected=self.nprocs,
                                     heartbeat_timeout=heartbeat_timeout)
        self.restarts = 0
        self._procs: List[subprocess.Popen] = []
        self._logs: Dict[str, str] = {}

    # -- one generation ------------------------------------------------------
    def _spawn(self, generation: int):
        coord_port = _free_port()
        host, port = self.supervisor.address
        self._procs = []
        self._left = set()
        for pid in range(self.nprocs):
            env = dict(self.env)
            env.update({
                "BIGDL_TPU_ELASTIC_ENABLED": "true",
                "BIGDL_TPU_ELASTIC_SUPERVISOR_ADDRESS": f"{host}:{port}",
                "BIGDL_TPU_ELASTIC_GENERATION": str(generation),
                "BIGDL_TPU_COORDINATOR_ADDRESS":
                    f"127.0.0.1:{coord_port}",
                "BIGDL_TPU_NUM_PROCESSES": str(self.nprocs),
                "BIGDL_TPU_PROCESS_ID": str(pid),
            })
            log_path = os.path.join(self.log_dir,
                                    f"worker-g{generation}-p{pid}.log")
            self._logs[f"g{generation}-p{pid}"] = log_path
            log = open(log_path, "wb")
            try:
                proc = subprocess.Popen(
                    self.worker_argv, stdout=log, stderr=log,
                    env=env, cwd=self.cwd)
            finally:
                log.close()   # the child holds its own fd
            self._procs.append(proc)
        logger.info("elastic: generation %d spawned (%d procs, "
                    "coordinator :%d)", generation, self.nprocs,
                    coord_port)

    def _kill_all(self):
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + self.grace
        for p in self._procs:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                # wedged in a dead collective: the SIGTERM handler's
                # iteration boundary never comes — escalate
                try:
                    p.kill()
                except OSError:
                    pass
                p.wait()

    def log_tails(self, n: int = 2000) -> Dict[str, str]:
        tails = {}
        for key, path in self._logs.items():
            try:
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    size = f.tell()
                    f.seek(max(size - n, 0))
                    tails[key] = f.read().decode(errors="replace")
            except OSError:
                tails[key] = "<log unreadable>"
        return tails

    # -- the supervision loop ------------------------------------------------
    def run(self, timeout: Optional[float] = None) -> dict:
        """Drive the job to completion; returns the run record."""
        self.supervisor.start()
        t0 = time.monotonic()
        try:
            self._spawn(self.supervisor.generation)
            while True:
                time.sleep(self.poll_interval)
                if timeout is not None and \
                        time.monotonic() - t0 > timeout:
                    self._kill_all()
                    raise ElasticJobFailed(
                        f"elastic job timed out after {timeout:g}s "
                        f"(generation {self.supervisor.generation})",
                        self.log_tails())
                codes = [p.poll() for p in self._procs]
                for i, c in enumerate(codes):
                    # a clean exit ends the peer's liveness obligation:
                    # without this, its heartbeat expiry would restart
                    # a healthy world while slower peers finish
                    if c == 0 and i not in self._left:
                        self._left.add(i)
                        self.supervisor.leave(i)
                if all(c == 0 for c in codes):
                    return {"generations": self.supervisor.generation + 1,
                            "restarts": self.restarts,
                            "exit_codes": codes,
                            "failures": [r for _, r in
                                         self.supervisor.failures],
                            "log_dir": self.log_dir}
                failed = [i for i, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed:
                    self.supervisor.fail(
                        f"process {failed[0]} exited with code "
                        f"{codes[failed[0]]}")
                if not self.supervisor.sweep():
                    self._restart()
        finally:
            self._kill_all()
            self.supervisor.stop()

    def _restart(self):
        from bigdl_tpu_torch import observability as obs
        self._kill_all()
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise ElasticJobFailed(
                f"restart budget exhausted ({self.max_restarts}) — "
                f"failures: {[r for _, r in self.supervisor.failures]}",
                self.log_tails())
        if obs.enabled():
            obs.counter(
                "bigdl_elastic_restarts_total",
                "Elastic restarts performed",
                labelnames=("scope",)).labels(scope="world").inc()
            obs.add_complete("elastic/restart", time.time(), 0.0,
                             stage="elastic",
                             generation=self.supervisor.generation + 1,
                             reason=self.supervisor.failures[-1][1]
                             if self.supervisor.failures else "")
        gen = self.supervisor.begin_generation()
        logger.warning("elastic: restarting worker set as generation "
                       "%d (restart %d/%d)", gen, self.restarts,
                       self.max_restarts)
        self._spawn(gen)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Launch an elastic multi-process training job: "
                    "supervisor + heartbeats + restart-on-failure. "
                    "Everything after `--` is the worker command.")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--max-restarts", type=int, default=None)
    ap.add_argument("--heartbeat-timeout", type=float, default=None)
    ap.add_argument("--timeout", type=float, default=None,
                    help="overall wall-clock budget (seconds)")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("worker", nargs=argparse.REMAINDER,
                    help="-- worker command and args")
    args = ap.parse_args(argv)
    worker = args.worker
    if worker and worker[0] == "--":
        worker = worker[1:]
    if not worker:
        ap.error("no worker command (pass it after `--`)")
    launcher = ElasticLauncher(worker, nprocs=args.nprocs,
                               max_restarts=args.max_restarts,
                               heartbeat_timeout=args.heartbeat_timeout,
                               log_dir=args.log_dir)
    try:
        record = launcher.run(timeout=args.timeout)
    except ElasticJobFailed as e:
        print(f"elastic job failed: {e}", file=sys.stderr)
        for key, tail in e.log_tails.items():
            print(f"--- {key} ---\n{tail}", file=sys.stderr)
        return 1
    print(f"elastic job done: generations={record['generations']} "
          f"restarts={record['restarts']} logs={record['log_dir']}")
    return 0


if __name__ == "__main__":
    signal.signal(signal.SIGINT, signal.SIG_DFL)
    sys.exit(main())

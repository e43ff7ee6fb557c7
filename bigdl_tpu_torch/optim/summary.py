"""Training summaries — the port of ``bigdl_tpu/optim/summary.py`` (ref: .../visualization/TrainSummary.scala,
ValidationSummary.scala — hand-rolled TensorBoard event files).

Here: torch.utils.tensorboard if importable (tensorboard wheels present),
else a JSONL scalar log with the same read-back API (``read_scalar``),
which is what the reference's summary reader offers (the card's machine
has no ``tensorboard``, so there the JSONL log is the record).

Every scalar is also routed through the port's observability registry
(one gauge per tag, labeled ``app``/``kind``), so the JSONL file,
TensorBoard and the Prometheus ``/metrics`` surface see one stream.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Tuple

from bigdl_tpu_torch import observability as obs


class Summary:
    def __init__(self, log_dir: str, app_name: str, kind: str,
                 flush_every: int = 64):
        self.dir = os.path.join(log_dir, app_name, kind)
        os.makedirs(self.dir, exist_ok=True)
        self.app_name = app_name
        self.kind = kind
        # flush at a coarse cadence, not per scalar: per-iteration
        # flushed writes serialize the hot loop on filesystem latency
        self.flush_every = max(int(flush_every), 1)
        self._pending = 0
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(self.dir)
        except Exception:
            pass
        self._jsonl = open(os.path.join(self.dir, "scalars.jsonl"), "a")
        self._gauge = None   # declared on first enabled add_scalar, so
        # a runtime obs.enable() picks up a live summary

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        if obs.enabled():
            if self._gauge is None:
                self._gauge = obs.gauge(
                    "bigdl_summary_scalar",
                    "Last value of each Train/ValidationSummary scalar "
                    "tag", labelnames=("app", "kind", "tag"))
            self._gauge.labels(app=self.app_name, kind=self.kind,
                               tag=tag).set(float(value))
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "wall": time.time()}) + "\n")
        self._pending += 1
        if self._pending >= self.flush_every:
            self._jsonl.flush()
            self._pending = 0

    def flush(self):
        self._jsonl.flush()
        self._pending = 0

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        out = []
        self.flush()
        path = os.path.join(self.dir, "scalars.jsonl")
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"] == tag:
                    out.append((rec["step"], rec["value"]))
        return out

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self.flush()
        self._jsonl.close()


class TrainSummary(Summary):
    def __init__(self, log_dir: str, app_name: str,
                 flush_every: int = 64):
        super().__init__(log_dir, app_name, "train",
                         flush_every=flush_every)


class ValidationSummary(Summary):
    def __init__(self, log_dir: str, app_name: str,
                 flush_every: int = 64):
        super().__init__(log_dir, app_name, "validation",
                         flush_every=flush_every)

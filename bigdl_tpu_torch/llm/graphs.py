"""CUDA graphs of the port's decode steps — the port's counterpart of the
JAX package's ``obs.compiled`` (``jax.jit``) around its compiled steps
(``bigdl_tpu/observability/compile_recorder.py``).

A step here is a function of no arguments over persistent buffers: it
reads its inputs from tensors made once and writes its outputs into
tensors made once, in place. (The JAX step donates its pools and returns
new arrays; here every call reads and writes the same tensors, so a
graph that bakes in their addresses stays valid, and replay N+1 reads
what replay N wrote.)

:class:`CapturedStep` runs the first call eagerly: the warm-up, on the
real step, does the first-call work (a kernel library's ``dlopen`` and
``cudaFuncSetAttribute``, cuBLAS handles) before any capture. The second
call captures the function into one CUDA graph on a side stream, and it
and every later call replay that graph on the current stream: one
``cudaGraphLaunch`` for the step's few thousand kernels.

On a CPU device every call runs the function eagerly (the caller asked
for the CPU, as the tests do). On the card a capture or a replay that
fails raises; there is no eager fallback.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import torch

from bigdl_tpu_torch.llm import kernels
from bigdl_tpu_torch.observability import compile_recorder


class CapturedStep:
    """``fn`` (no arguments, persistent buffers in and out) run as one
    captured CUDA graph from its second call on.

    ``generators``: the ``torch.Generator`` s ``fn`` draws from; each is
    registered with the graph before capture, so every replay advances
    it and draws new numbers (an unregistered one would replay the noise
    of the capture). Capture uses ``capture_error_mode="thread_local"``:
    the engine captures on its own thread while other threads go on
    making CUDA calls.

    After the capture: ``launches``, one replay's kernel launches by
    counter (:func:`kernels.launches_of_capture`; each replay adds them
    to the counters, the capture adds nothing); ``capture_seconds``; and
    ``pool_bytes``, the device memory the graph's private pool holds (the
    step's temporaries), as the allocator's reserved bytes grew over the
    capture.

    Each capture records one entry in the capture records
    (:func:`~bigdl_tpu_torch.observability.compile_recorder.
    record_capture`) under ``name``, the JAX engine's program name, with
    its capture seconds, pool bytes, launches a replay and ``costs``
    (the FLOPs and bytes a call, reckoned by the caller from the step's
    shapes: ``serving.step_costs``).

    ``eager`` runs ``fn`` every call and never captures: for a step that
    syncs with the host (a gloo collective), which a graph cannot hold."""

    def __init__(self, fn: Callable[[], None], device,
                 generators: Iterable[torch.Generator] = (),
                 name: str = "captured_step", signature: str = "",
                 costs: Optional[Dict[str, float]] = None,
                 eager: bool = False):
        self.fn = fn
        self.eager = eager
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.name = name
        self.signature = signature
        self.costs = costs
        self.captures = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.calls = 0
        self.replays = 0
        self.launches: Dict[str, int] = {}
        self.capture_seconds: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def __call__(self) -> None:
        self.calls += 1
        if self.device.type != "cuda" or self.calls == 1 or self.eager:
            self.fn()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        kernels.add_launches(self.launches)
        self.replays += 1
        if self.replays == 1:
            # a fault inside a replay shows only at the next synchronising
            # call: make the first replay's show here
            torch.cuda.current_stream(self.device).synchronize()

    def _capture(self):
        t0 = time.perf_counter()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.device(self.device), \
                kernels.launches_of_capture() as delta, \
                torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.fn()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self.launches = graph, delta
        self.capture_seconds = time.perf_counter() - t0
        compile_recorder.record_capture(
            self.name, self.capture_seconds, self.pool_bytes, delta,
            costs=self.costs, signature=self.signature,
            recapture=self.captures > 0)
        self.captures += 1

    def close(self):
        """Free the graph and its pool. A later call warms up and captures
        again."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.calls = self.replays = 0

"""Hand-written CUDA kernels of the port's paths (the served Llama path,
``generate()`` and the low-bit DLlib/nano path) and their plain PyTorch
versions.
Importing this package builds nothing; the kernels compile at first
launch, or all at once with :func:`build_kernels`."""

import contextlib

from bigdl_tpu_torch.llm.kernels import _build, _counts
from bigdl_tpu_torch.llm.kernels.int4_matmul import (
    TC_MIN_M, TC_SMS, asym_int4_matmul, asym_int4_matmul_grouped,
    asym_int4_matmul_reference, dequant_q4, dequant_q4_1, dequant_q8_0,
    int4_matmul, int4_matmul_grouped, int4_matmul_reference, int8_matmul,
    int8_matmul_grouped, int8_matmul_reference, gemv_slices, matmul_route,
    quantize_tpu, tc_block_shape, to_tpu_layout)
from bigdl_tpu_torch.llm.kernels.paged_attention import (
    SPLIT_KEYS, merge_attention_partial, paged_attention,
    paged_attention_decode, paged_attention_decode_stats,
    paged_attention_reference, paged_attention_reference_stats,
    paged_attention_stats, split_stats_reference)
from bigdl_tpu_torch.llm.kernels.ragged_prefill import (
    ragged_prefill, ragged_prefill_attention, ragged_prefill_reference,
    ragged_route, ragged_tiles_reference)
from bigdl_tpu_torch.llm.kernels.sampling import (make_sampled_step,
                                                  sample_tokens)

# csrc/<name>.cu sources, one shared library each
KERNEL_SOURCES = ("int4_matmul_tc", "lowbit_gemv", "lowbit_matmul_tc",
                  "paged_attention", "ragged_prefill", "ragged_prefill_tc")

# the wrappers whose ``launches`` count the kernels of the port's paths
WRAPPERS = {"int4_matmul": int4_matmul,
            "asym_int4_matmul": asym_int4_matmul,
            "int8_matmul": int8_matmul,
            "paged_attention_decode_stats": paged_attention_decode_stats,
            "ragged_prefill_attention": ragged_prefill_attention,
            "paged_attention_decode": paged_attention_decode}


def build_kernels():
    """Compile every kernel source in parallel (one ``nvcc`` each) and
    load the libraries; returns ``{source: seconds}`` for the sources
    built in this call (empty when all were cached)."""
    before = dict(_build.build_seconds)
    _build.build_all(KERNEL_SOURCES)
    return {k: v for k, v in _build.build_seconds.items()
            if before.get(k) != v}


# the wrappers with two kernels, whose ``tc_launches`` count the launches
# that took the tensor-core route (``matmul_route`` for the
# dequant-matmuls, ``ragged_route`` for ragged prefill)
TC_WRAPPERS = (int4_matmul, asym_int4_matmul, int8_matmul,
               ragged_prefill_attention)
# the dequant-matmuls, whose ``gemv_launches`` count the launches of the
# split-K GEMV (``matmul_route`` "gemv")
GEMV_WRAPPERS = (int4_matmul, asym_int4_matmul, int8_matmul)
# launch_counts() key suffix -> the counter it reads
_ROUTE_COUNTERS = {"_tc": ("tc_launches", TC_WRAPPERS),
                   "_gemv": ("gemv_launches", GEMV_WRAPPERS)}


def reset_launch_counts():
    _counts.add([(w, attr, -getattr(w, attr))
                 for w, attr in map(_counter, launch_counts())])


def launch_counts():
    """Launches per wrapper, ``<wrapper>_tc`` for each wrapper of
    ``TC_WRAPPERS`` (how many of its launches took the tensor-core
    route) and ``<wrapper>_gemv`` for each of ``GEMV_WRAPPERS`` (how many
    took the GEMV)."""
    counts = {name: w.launches for name, w in WRAPPERS.items()}
    for suffix, (attr, ws) in _ROUTE_COUNTERS.items():
        for w in ws:
            counts[f"{w.__name__}{suffix}"] = getattr(w, attr)
    return counts


def _counter(name):
    """The ``(wrapper, attribute)`` behind a :func:`launch_counts` key."""
    if name in WRAPPERS:
        return WRAPPERS[name], "launches"
    suffix = next(s for s in _ROUTE_COUNTERS if name.endswith(s))
    return (WRAPPERS[name.removesuffix(suffix)],
            _ROUTE_COUNTERS[suffix][0])


def _add_counts(delta, sign: int = 1):
    _counts.add([(*_counter(name), sign * n) for name, n in delta.items()])


@contextlib.contextmanager
def launches_of_capture():
    """Count what a CUDA graph capture launches without counting it: a
    capture runs no kernel, yet each wrapper bumps its counter as it
    records one. Yields a dict that holds, on exit, the capture's
    ``{launch_counts() key: n}`` delta; the counters are then set back
    by that delta. Each replay of the graph adds it
    (:func:`add_launches`), so the counters read as if every replayed
    kernel had been launched from Python. What other threads launch or
    replay during the capture stays out of its delta."""
    delta = {}
    try:
        with _counts.others_during(launch_counts) as (before, res):
            yield delta
    finally:
        keys = {_counter(k): k for k in res["after"]}
        own = {k: n - before[k] for k, n in res["after"].items()}
        for counter, n in res["others"].items():
            own[keys[counter]] -= n
        delta.update({k: n for k, n in own.items() if n})
        _add_counts(delta, -1)


def add_launches(delta):
    """Add one graph replay's launches (a :func:`launches_of_capture`
    delta) to the counters."""
    _add_counts(delta)


__all__ = ["GEMV_WRAPPERS", "KERNEL_SOURCES",
           "SPLIT_KEYS", "TC_MIN_M", "TC_SMS", "TC_WRAPPERS", "WRAPPERS",
           "asym_int4_matmul",
           "asym_int4_matmul_grouped", "asym_int4_matmul_reference",
           "add_launches", "build_kernels", "dequant_q4", "dequant_q4_1",
           "dequant_q8_0", "gemv_slices",
           "int4_matmul", "int4_matmul_grouped", "int4_matmul_reference",
           "int8_matmul", "int8_matmul_grouped", "int8_matmul_reference",
           "launch_counts", "launches_of_capture", "matmul_route",
           "make_sampled_step", "merge_attention_partial", "paged_attention",
           "paged_attention_decode", "paged_attention_decode_stats",
           "paged_attention_reference", "paged_attention_reference_stats",
           "paged_attention_stats", "quantize_tpu", "ragged_prefill",
           "ragged_prefill_attention", "ragged_prefill_reference",
           "ragged_route", "ragged_tiles_reference", "reset_launch_counts",
           "sample_tokens", "split_stats_reference",
           "tc_block_shape", "to_tpu_layout"]

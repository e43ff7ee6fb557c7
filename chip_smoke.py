#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phase 0  require a CUDA device (exit 2 without one) and print the card's
         name and power limit as ``nvidia-smi`` gives them.
Phase 1  build every CUDA kernel from ``bigdl_tpu_torch/csrc`` (one
         ``nvcc`` per source, all in parallel) and print the seconds.
Phase 2  hold each kernel against its plain PyTorch version on the card
         at the Llama-2-7B shapes of the served path, plus GQA (Hq 32,
         Hkv 8), D=64 and sliding-window shapes, and the three
         dequant-matmuls at the BERT-base shapes (and q4_0 at N = 2, 3,
         770); inputs from a seeded ``torch.Generator`` on the card. One
         JSON line per case with the errors, the tolerance, the
         kernel's / plain version's / one PyTorch library call's time
         (CUDA events, median of 25 calls run back to back after
         warm-up) and the bound (bytes over 3.35 TB/s or FLOPs over
         989 TFLOP/s, whichever is larger).
Phase 3  the served path on the card against the port's plain path on
         the CPU on a small input (7B width, 2 layers): prefill and decode
         logits within 2e-2 of their largest magnitude. Then build
         Llama-2-7B at full width and depth with synthetic q4_0
         weights made on the card, serve 8 greedy requests (prompts of
         17..300 tokens, 32 new tokens each) through ``LLMServer``
         (max_batch 8, max_seq_len 512, page 16), check every request got
         32 in-vocab tokens, that the launch counters (zeroed just before)
         are exactly what the path must launch, and that one request
         served again alone on a fresh server gives the same tokens.
         Prints TTFT, decode tok/s and peak device memory.
Phase 4  trace one 7B batch-8 decode step with ``torch.profiler``:
         step wall time, device busy time and idle share, kernel
         launches per step, the kernels that take the time.
Phase 5  BERT-base (full width, 12 layers, random weights from a seed)
         through nano's ``InferenceOptimizer``: ``trace`` (float, the
         yardstick), ``quantize`` to int8 / asym_int4 / sym_int4 and
         ``nn.quantized.quantize_model``, batch 8 x 128: exactly 74
         launches of the pipeline's matmul kernel per forward (0 of the
         others), ms per forward, sequences/s, peak memory, and the
         card's log-probs against the same model's plain path on the CPU
         (batch 2 x 128). Then one int8 forward traced as in phase 4.

Then a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises: the run
ends nonzero and prints no result. The full report also goes to
``chiprun_out/chip_smoke.json``. Imports nothing of JAX or ``bigdl_tpu``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, iters=25, warmup=3):
    """Median device time of one call over ``iters`` calls run back to
    back: a CUDA event after each call, and the card held busy
    (``torch.cuda._sleep``) while the host enqueues them all, so a short
    kernel is timed on the device and not at the rate the host can
    launch it. A call that synchronises inside (the plain versions read
    lengths back) is timed with its host gaps included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    # ~2e9 cycles a second at the H100's boost clock; capped at 2 s
    torch.cuda._sleep(int(min(host_s * iters * 1.5, 2.0) * 2e9))
    evs[0].record()
    for i in range(iters):
        fn()
        evs[i + 1].record()
    evs[-1].synchronize()
    return statistics.median(evs[i].elapsed_time(evs[i + 1])
                             for i in range(iters))


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


# -- phase 2: kernels against their plain versions ---------------------------

# the linears of BERT-base at batch 8 x 128 (M = 1024 rows), and the pooler
# and classifier, which see one row per sequence; the last field is how
# many of each one forward launches (12 layers)
BERT_SHAPES = (("qkvo", 1024, 768, 768, 48), ("ffn1", 1024, 768, 3072, 12),
               ("ffn2", 1024, 3072, 768, 12), ("pooler", 8, 768, 768, 1),
               ("classifier", 8, 768, 2, 1))


def _planes(torch, dev, gen, kind, k, n):
    """Random weights in the k-major layout of ``kind``'s kernel."""
    s = torch.empty((k // 32, n), device=dev).uniform_(0.001, 0.02,
                                                        generator=gen)
    if kind == "int8_matmul":
        return (torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8), s)
    q = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                      dtype=torch.uint8)
    if kind == "int4_matmul":
        return q, s
    z = torch.empty((k // 32, n), device=dev).uniform_(-0.15, 0.0,
                                                       generator=gen)
    return q, s, z


def matmul_case(torch, dev, gen, kind, what, m, k, n, path_dtype,
                launches=0, per=None):
    """One dequant-matmul case: the kernel's f32-out and bf16-out entries
    against the plain version on the same bf16 x and planes; the entry
    the path launches (``path_dtype`` out) is the one timed. ``launches``
    is how many calls of this shape the path makes ``per`` step or
    forward (0: a shape no path runs)."""
    from bigdl_tpu_torch.llm import kernels as K
    fn, ref, deq = {
        "int4_matmul": (K.int4_matmul, K.int4_matmul_reference,
                        K.dequant_q4),
        "asym_int4_matmul": (K.asym_int4_matmul,
                             K.asym_int4_matmul_reference, K.dequant_q4_1),
        "int8_matmul": (K.int8_matmul, K.int8_matmul_reference,
                        K.dequant_q8_0)}[kind]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    planes = _planes(torch, dev, gen, kind, k, n)
    got = fn(x, *planes, out_dtype=torch.float32)
    want = ref(x, *planes, torch.float32)
    got16 = fn(x, *planes, out_dtype=torch.bfloat16)
    want16 = ref(x, *planes, torch.bfloat16)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    tol = 2e-5 * scale
    err16 = (got16.float() - want16.float()).abs().max().item()
    tol16 = 1e-4 + 2.0 ** -7 * scale
    w16 = deq(*planes, dtype=torch.bfloat16)
    out_bytes = 2 if path_dtype == torch.bfloat16 else 4
    nbytes = (m * k * 2 + sum(p.numel() * p.element_size() for p in planes)
              + m * n * out_bytes)
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
    row = {
        "kernel": kind, "case": f"{what} M={m} K={k} N={n}",
        "path_out": str(path_dtype).replace("torch.", ""),
        "max_abs_err": err, "max_rel_err": err / scale, "tol": tol,
        "tol_rule": "f32 out: 2e-5 * max|plain| (f32 sums, another order); "
                    "bf16 out: 1e-4 + 1 bf16 ulp of max|plain| (2^-7 of it)",
        "max_abs_err_bf16out": err16, "tol_bf16out": tol16,
        "ms": time_ms(lambda: fn(x, *planes, out_dtype=path_dtype)),
        "plain_ms": time_ms(lambda: ref(x, *planes, path_dtype)),
        "library_ms": time_ms(lambda: torch.matmul(x, w16)),
        "library": "torch.matmul(x, dequantized bf16 w)",
        "bound_ms": b_ms, "bound_by": b_by,
        "launches": launches, "launches_per": per,
        "passed": err <= tol and err16 <= tol16}
    del x, planes, got, want, got16, want16, w16
    return row


def int4_cases(torch, dev, gen):
    """q4_0 at the Llama-2-7B shapes (bf16 out, as served), at the BERT
    shapes (f32 out, as the sym_int4 pipeline runs it) and at N = 3 and
    770 (N not a multiple of 4)."""
    out = []
    for m, per in ((8, "7B decode step"), (512, "7B prefill")):
        for k, n, what, count in (
                (4096, 12288, "qkv_proj", 32), (4096, 4096, "o_proj", 32),
                (4096, 22016, "gate_up_proj", 32),
                (11008, 4096, "down_proj", 32), (4096, 32000, "lm_head", 1)):
            out.append(matmul_case(torch, dev, gen, "int4_matmul", what, m,
                                   k, n, torch.bfloat16, count, per))
    for what, m, k, n, count in BERT_SHAPES:
        out.append(matmul_case(torch, dev, gen, "int4_matmul",
                               f"BERT {what}", m, k, n, torch.float32, count,
                               "BERT sym_int4 forward"))
    for n in (3, 770):
        out.append(matmul_case(torch, dev, gen, "int4_matmul", "odd N", 8,
                               768, n, torch.float32))
    return out


def lowbit_cases(torch, dev, gen):
    """q4_1 and q8_0 at the BERT-base shapes, f32 out as the pipelines
    run them."""
    return [matmul_case(torch, dev, gen, kind, f"BERT {what}", m, k, n,
                        torch.float32, count, f"BERT {qtype} forward")
            for kind, qtype in (("int8_matmul", "int8"),
                                ("asym_int4_matmul", "asym_int4"))
            for what, m, k, n, count in BERT_SHAPES]


def _gathered(torch, pages, bt, n_tok, g):
    """(P, Hkv, page, D) → (B, Hq, n_tok, D), GQA heads expanded."""
    b = bt.shape[0]
    _, hkv, page, d = pages.shape
    npg = -(-n_tok // page)
    a = pages[bt[:, :npg].long()].permute(0, 2, 1, 3, 4).reshape(
        b, hkv, npg * page, d)[:, :, :n_tok]
    return a.repeat_interleave(g, dim=1)


def paged_cases(torch, dev, gen):
    import torch.nn.functional as F
    from bigdl_tpu_torch.llm.kernels.paged_attention import (
        paged_attention_decode_stats, paged_attention_reference_stats)
    page, B, maxp = 16, 8, 32
    lens_main = [17, 57, 98, 139, 180, 220, 260, 300]
    out = []
    for what, hq, hkv, d, win, lens in (
            ("7B decode", 32, 32, 128, None, lens_main),
            ("GQA Hkv=8", 32, 8, 128, None, [0] + lens_main[1:]),
            ("D=64", 32, 32, 64, None, lens_main),
            ("GQA window=100", 32, 8, 128, 100, lens_main)):
        P = 1 + B * maxp
        q = torch.randn((B, hq, d), generator=gen, device=dev).to(
            torch.bfloat16)
        kp = torch.randn((P, hkv, page, d), generator=gen, device=dev).to(
            torch.bfloat16)
        vp = torch.randn((P, hkv, page, d), generator=gen, device=dev).to(
            torch.bfloat16)
        bt = (1 + torch.randperm(P - 1, generator=gen, device=dev)[
            :B * maxp]).reshape(B, maxp).to(torch.int32)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        acc, m, l = paged_attention_decode_stats(q, kp, vp, bt, ln, page,
                                                 sliding_window=win)
        racc, rm, rl = paged_attention_reference_stats(
            q, kp, vp, bt, ln, sliding_window=win)
        torch.cuda.synchronize()
        live = ln > 0
        o, ro = (acc[live] / l[live][..., None],
                 racc[live] / rl[live][..., None])
        err = (o - ro).abs().max().item()
        err_m = (m - rm).abs().max().item()
        err_l = ((l - rl).abs() / rl.clamp(min=1)).max().item()
        empty_ok = bool(torch.all(m[~live] == -1e30)
                        and torch.all(l[~live] == 0)
                        and torch.all(acc[~live] == 0))
        # library yardstick: SDPA over the gathered live K/V
        smax = max(lens)
        kg = _gathered(torch, kp, bt, smax, hq // hkv)
        vg = _gathered(torch, vp, bt, smax, hq // hkv)
        pos = torch.arange(smax, device=dev)[None]
        mask = pos < ln[:, None].long()
        if win is not None:
            mask &= pos >= ln[:, None].long() - win
        mask[:, 0] |= ~mask.any(dim=1)          # keep empty rows finite
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]
        n_att = sum(min(x, win) if win else x for x in lens)
        nbytes = (q.numel() * 2 + n_att * hkv * d * 2 * 2 + bt.numel() * 4
                  + B * 4 + acc.numel() * 4 + 2 * m.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * n_att * hq * d)
        out.append({
            "kernel": "paged_attention_decode_stats",
            "case": f"{what} B={B} Hq={hq} Hkv={hkv} D={d} page={page}",
            "max_abs_err": err, "max_abs_err_m": err_m,
            "max_rel_err_l": err_l, "tol": 1e-3,
            "tol_rule": "1e-3 on acc/l and m, 1e-3 relative on l "
                        "(f32 math on the same bf16 K/V)",
            "ms": time_ms(lambda: paged_attention_decode_stats(
                q, kp, vp, bt, ln, page, sliding_window=win)),
            "plain_ms": time_ms(lambda: paged_attention_reference_stats(
                q, kp, vp, bt, ln, sliding_window=win)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q4, kg, vg, attn_mask=mask)),
            "library": "F.scaled_dot_product_attention on gathered K/V",
            "bound_ms": b_ms, "bound_by": b_by,
            "passed": (err <= 1e-3 and err_m <= 1e-3 and err_l <= 1e-3
                       and empty_ok)})
    return out


def ragged_cases(torch, dev, gen):
    import torch.nn.functional as F
    from bigdl_tpu_torch.llm.kernels.ragged_prefill import (
        ragged_prefill_attention, ragged_prefill_reference)
    page, P, maxp = 16, 64, 32
    out = []
    for what, hq, hkv, d, off, slen, tq, win in (
            ("7B prefill", 32, 32, 128, 0, 300, 512, None),
            ("7B offset>0", 32, 32, 128, 64, 200, 256, None),
            ("GQA Hkv=8", 32, 8, 128, 32, 256, 256, None),
            ("D=64", 32, 32, 64, 20, 100, 128, None),
            ("GQA window=64", 32, 8, 128, 48, 150, 256, 64)):
        q = torch.randn((1, tq, hq, d), generator=gen, device=dev).to(
            torch.bfloat16)
        ks, vs = (torch.randn((1, tq, hkv, d), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        kp, vp = (torch.randn((P, hkv, page, d), generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        bt = torch.randperm(P, generator=gen, device=dev)[:maxp].reshape(
            1, maxp).to(torch.int32)
        offs = torch.tensor([off], dtype=torch.int32, device=dev)
        lens = torch.tensor([slen], dtype=torch.int32, device=dev)
        args = (q, ks, vs, kp, vp, bt, offs, lens)
        got = ragged_prefill_attention(*args, page_size=page,
                                       sliding_window=win)
        want = ragged_prefill_reference(*args, sliding_window=win)
        torch.cuda.synchronize()
        err = (got[:, :slen] - want[:, :slen]).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        # library yardstick: SDPA over gathered prefix + suffix K/V
        g = hq // hkv
        kpre = _gathered(torch, kp, bt, off, g) if off else None
        vpre = _gathered(torch, vp, bt, off, g) if off else None
        ksuf = ks[0, :slen].permute(1, 0, 2).repeat_interleave(g, 0)[None]
        vsuf = vs[0, :slen].permute(1, 0, 2).repeat_interleave(g, 0)[None]
        kall = torch.cat([kpre, ksuf], 2) if off else ksuf
        vall = torch.cat([vpre, vsuf], 2) if off else vsuf
        qpos = off + torch.arange(slen, device=dev)[:, None]
        kpos = torch.arange(off + slen, device=dev)[None]
        mask = kpos <= qpos
        if win is not None:
            mask &= kpos > qpos - win
        ql = q[0, :slen].permute(1, 0, 2)[None]
        keys = [min(off + j + 1, win) if win else off + j + 1
                for j in range(slen)]
        # prefix positions some query needs (the window may drop some)
        n_pre = off - (max(0, off - win + 1) if win else 0)
        # the kernel reads only the seq_len live rows of q and of the
        # suffix K/V; it writes all Tq output rows (padding comes out
        # finite, by contract)
        nbytes = (slen * hq * d * 2 + 2 * slen * hkv * d * 2
                  + n_pre * hkv * d * 2 * 2 + got.numel() * 4)
        b_ms, b_by = bound(nbytes, 4.0 * sum(keys) * hq * d)
        out.append({
            "kernel": "ragged_prefill_attention",
            "case": f"{what} Tq={tq} seq_len={slen} offset={off} Hq={hq} "
                    f"Hkv={hkv} D={d}" + (f" window={win}" if win else ""),
            "max_abs_err": err, "tol": 1e-3,
            "tol_rule": "1e-3 on the valid rows (f32 softmax of the same "
                        "bf16 K/V); padded rows finite",
            "ms": time_ms(lambda: ragged_prefill_attention(
                *args, page_size=page, sliding_window=win)),
            "plain_ms": time_ms(lambda: ragged_prefill_reference(
                *args, sliding_window=win)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                ql, kall, vall, attn_mask=mask)),
            "library": "F.scaled_dot_product_attention on gathered K/V",
            "bound_ms": b_ms, "bound_by": b_by,
            "passed": err <= 1e-3 and finite})
    return out


# -- phase 3: the served path at 7B -------------------------------------------

def serve_7b(torch, dev):
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.models.llama import LlamaConfig, LlamaForCausalLM
    from bigdl_tpu_torch.llm.serving import LLMServer

    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM.synthetic_q4(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(1)
    plens = [17, 57, 98, 139, 180, 220, 260, 300]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen)
               .numpy() for n in plens]
    kw = dict(max_batch=8, max_seq_len=512, page_size=16)

    srv = LLMServer(model, **kw).start()
    try:
        # warm-up outside the measured window: CUDA context, kernel
        # loads and cuBLAS handles are first touched here
        srv.submit(prompts[0], max_new_tokens=2).get(timeout=600)
        check(not srv.errors, f"engine errors: {srv.errors}")
        steps0 = srv.steps
        kernels.reset_launch_counts()
        t_start = time.perf_counter()
        reqs = [srv.submit(p, max_new_tokens=32) for p in prompts]
        outs = [r.get(timeout=900) for r in reqs]
        t_end = time.perf_counter()
        counts = kernels.launch_counts()
        steps = srv.steps - steps0
    finally:
        srv.stop()
    check(not srv.errors, f"engine errors: {srv.errors}")
    for i, toks in enumerate(outs):
        check(len(toks) == 32, f"request {i}: {len(toks)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {i}: token out of vocab")
    L = cfg.num_hidden_layers
    n_prefill = len(prompts)
    expect = {"int4_matmul": (n_prefill + steps) * (4 * L + 1),
              "asym_int4_matmul": 0, "int8_matmul": 0,
              "paged_attention_decode_stats": steps * L,
              "ragged_prefill_attention": n_prefill * L}
    check(all(counts[k] > 0 for k, v in expect.items() if v),
          f"a kernel of the served path never ran: {counts}")
    check(counts == expect, f"launch counts {counts} != expected {expect}")
    ttft = [r.t_first_token - r.t_submit for r in reqs]
    decode_s = t_end - max(r.t_first_token for r in reqs)
    decode_tokens = sum(len(o) - 1 for o in outs)
    peak = torch.cuda.max_memory_allocated()
    del srv

    # one request again, alone, on a fresh server: the same tokens
    alone_i = 3
    srv2 = LLMServer(model, **kw).start()
    try:
        alone = srv2.submit(prompts[alone_i], max_new_tokens=32).get(
            timeout=600)
    finally:
        srv2.stop()
    check(alone == outs[alone_i], f"request {alone_i} alone {alone} != "
          f"batched {outs[alone_i]}")
    return {
        "phase": "serve", "model": "Llama-2-7B q4_0 (synthetic weights, "
        "32 layers, full width)", "requests": len(prompts),
        "prompt_lens": plens, "max_new_tokens": 32, "decode_steps": steps,
        "launches": counts, "weights_build_s": build_s,
        "ttft_ms_mean": statistics.mean(ttft) * 1e3,
        "ttft_ms_max": max(ttft) * 1e3,
        "wall_s": t_end - t_start,
        "decode_tok_per_s": decode_tokens / decode_s,
        "decode_step_ms": decode_s / max(steps - 1, 1) * 1e3,
        "peak_mem_gb": peak / 1e9, "alone_equals_batched": True,
        "tokens_first_request": outs[0]}, model


def reference_check(torch, dev):
    """The served path on the card against the port's plain path on the
    CPU, on a small input: Llama-2-7B at full width cut to 2 layers, the
    same synthetic q4_0 weights on both devices, one ragged prefill of a
    40-token prompt and one paged decode step (the same token fed to
    both). Logits must agree to 2e-2 of their largest magnitude: both
    sides run bf16 activations and f32 accumulation, and differ only
    where bf16 rounds a value that the other side's f32 sums put a hair
    across a rounding boundary."""
    import dataclasses
    from bigdl_tpu_torch.llm.models.llama import (LlamaConfig,
                                                  LlamaForCausalLM,
                                                  paged_prefill_ragged)
    from bigdl_tpu_torch.llm.serving import paged_decode_step

    cfg = dataclasses.replace(LlamaConfig.llama2_7b(), num_hidden_layers=2)
    gpu = LlamaForCausalLM.synthetic_q4(cfg, device=dev, seed=3)
    cpu = LlamaForCausalLM(cfg, gpu.params, device="cpu")
    page, T, bucket = 16, 40, 64
    prompt = torch.randint(0, cfg.vocab_size, (1, bucket),
                           generator=torch.Generator().manual_seed(2))
    bt_row = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    pos = torch.arange(bucket)
    phys = torch.where(pos < T, bt_row[(pos // page).clamp(max=3)],
                       torch.zeros_like(pos)).to(torch.int32)
    slots = (pos % page).to(torch.int32)
    out, tok = {}, None
    for name, m in (("gpu", gpu), ("cpu", cpu)):
        d = m.device
        shape = (cfg.num_hidden_layers, 6, cfg.num_key_value_heads, page,
                 cfg.head_dim)
        kp = torch.zeros(shape, dtype=m.cache_dtype, device=d)
        vp = torch.zeros(shape, dtype=m.cache_dtype, device=d)
        with torch.inference_mode():
            kp, vp, last = paged_prefill_ragged(
                m.params, cfg, kp, vp, prompt.to(d), T, 0, bt_row.to(d),
                phys.to(d), slots.to(d), 0, 0, page=page)
            if tok is None:
                tok = int(last.argmax())
            logits = paged_decode_step(
                m.params, cfg, kp, vp, bt_row[None].to(d),
                torch.tensor([T], dtype=torch.int32, device=d),
                torch.tensor([tok], device=d), page=page)[0]
        out[name] = (last.float().cpu(), logits[0].float().cpu())
    errs = {}
    for i, what in enumerate(("prefill", "decode")):
        g, c = out["gpu"][i], out["cpu"][i]
        check(bool(torch.isfinite(g).all()), f"{what} logits not finite")
        errs[what] = ((g - c).abs().max() / c.abs().max()).item()
    tol = 2e-2
    check(max(errs.values()) <= tol, f"card vs CPU logits: {errs}")
    return {"phase": "reference", "model": "Llama-2-7B width, 2 layers, "
            "synthetic q4_0", "prompt_tokens": T,
            "max_rel_err_logits": errs, "tol": tol, "passed": True}


def profile(torch, step, what, steps=3):
    """Where one ``step()`` call's time goes: its host-clock wall time
    (median of 5; ``step`` ends in a fetch to the host), then a
    ``torch.profiler`` trace of ``steps`` calls (CUDA kernel intervals:
    device busy time, kernel launches, time by kernel)."""
    from torch.profiler import ProfilerActivity, profile as trace

    with torch.inference_mode():
        for _ in range(2):
            step()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
    cuda_t = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == cuda_t]
    by_name = {}
    for e in kern:
        n = e.name if len(e.name) < 60 else e.name[:57] + "..."
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    busy = sum(t for t, _ in by_name.values()) / steps
    wall = statistics.median(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"phase": "profile", "what": what, "step_wall_ms": wall,
            "device_busy_ms": busy if kern else None,
            "device_idle_share": (1 - busy / wall) if kern else None,
            "kernel_launches_per_step": len(kern) / steps,
            "top_kernels_ms_per_step": {n: [t / steps, c / steps]
                                        for n, (t, c) in top}}


def profile_decode(torch, model):
    """A 7B batch-8 decode step: the engine's own step function
    (``paged_decode_step_sampled``) on a mid-decode state, to the token
    fetch."""
    from bigdl_tpu_torch.llm.serving import paged_decode_step_sampled

    cfg, dev = model.config, model.device
    B, page, cap = 8, 16, 32
    L, P = cfg.num_hidden_layers, 1 + B * cap
    shape = (L, P, cfg.num_key_value_heads, page, cfg.head_dim)
    kp = torch.zeros(shape, dtype=model.cache_dtype, device=dev)
    vp = torch.zeros(shape, dtype=model.cache_dtype, device=dev)
    bt = (1 + torch.arange(B * cap, device=dev)).reshape(B, cap).to(
        torch.int32)
    lens = torch.tensor([33, 73, 114, 155, 196, 236, 276, 316],
                        dtype=torch.int32, device=dev)
    last = torch.randn((B, cfg.vocab_size), device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)

    def step():
        toks = paged_decode_step_sampled(model.params, cfg, kp, vp, bt, lens,
                                         last, active, page=page)[0]
        return toks.cpu()

    return profile(torch, step, "7B decode step, batch 8, lens 33..316")


# -- phase 5: the BERT-base low-bit path --------------------------------------

# which kernel each pipeline's linears launch; 6 linears in each of the 12
# layers, plus the pooler and the classifier
BERT_PIPELINE_KERNELS = {"float (trace)": None, "int8": "int8_matmul",
                         "asym_int4": "asym_int4_matmul",
                         "sym_int4": "int4_matmul",
                         "quantize_model": "int8_matmul"}
MATMUL_KERNELS = ("int4_matmul", "asym_int4_matmul", "int8_matmul")


def bert_path(torch, dev):
    """BERT-base (full width, 12 layers, weights from a seed) through
    nano's pipelines: ``trace`` (float, the yardstick),
    ``InferenceOptimizer.quantize`` with int8 / asym_int4 / sym_int4, and
    the DLlib ``nn.quantized.quantize_model`` surgery. Each pipeline
    serves batch 8 x 128: exact launch counts (zeroed just before), ms
    per forward (median of 10, host clock to the numpy result),
    sequences/s, peak memory; then the card's log-probs against the same
    quantized model's plain path on the CPU at batch 2 x 128 — within
    2e-2 of their largest magnitude (the kernels read x in bf16, the CPU
    path in f32) and the same argmax on every row."""
    import copy

    import numpy as np
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.models.bert import BertConfig, build_classifier
    from bigdl_tpu_torch.nano import InferenceOptimizer
    from bigdl_tpu_torch.nano.inference_optimizer import _CompiledModel
    from bigdl_tpu_torch.nn import set_seed

    cfg = BertConfig.base()
    set_seed(0)
    t0 = time.perf_counter()
    model = build_classifier(cfg, 2, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.randint(0, cfg.vocab_size, (8, 128),
                        generator=torch.Generator().manual_seed(5)).numpy()
    n_linears = 6 * cfg.num_hidden_layers + 2
    builders = {
        "float (trace)": lambda: InferenceOptimizer.trace(model, device=dev),
        "int8": lambda: InferenceOptimizer.quantize(model, "int8",
                                                    device=dev),
        "asym_int4": lambda: InferenceOptimizer.quantize(
            model, "asym_int4", device=dev),
        "sym_int4": lambda: InferenceOptimizer.quantize(
            model, "sym_int4", device=dev),
        "quantize_model": lambda: InferenceOptimizer._quantize_convs(
            model, device=dev)}
    rows = {}
    for name, build in builders.items():
        t0 = time.perf_counter()
        pipe = build()
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        pipe.forward(ids)                    # warm-up: cuBLAS handles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        y = pipe.forward(ids)
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check(y.shape == (8, 2) and bool(np.isfinite(y).all()),
              f"BERT {name}: output {y.shape} not finite")
        want = dict.fromkeys(counts, 0)
        if BERT_PIPELINE_KERNELS[name]:
            want[BERT_PIPELINE_KERNELS[name]] = n_linears
        check(counts == want, f"BERT {name}: launch counts {counts} != "
              f"{want}")
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            pipe.forward(ids)
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(walls)
        cpu = _CompiledModel(copy.deepcopy(pipe._model), "cpu").forward(
            ids[:2])
        card = pipe.forward(ids[:2])
        err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
        same = bool((card.argmax(1) == cpu.argmax(1)).all())
        check(err <= 2e-2 and same, f"BERT {name}: card vs CPU log-probs "
              f"{card.tolist()} vs {cpu.tolist()} (rel err {err})")
        rows[name] = {"kernel": BERT_PIPELINE_KERNELS[name],
                      "launches": counts, "convert_s": convert_s,
                      "ms_per_forward": ms, "ms_all": walls,
                      "sequences_per_s": 8 / ms * 1e3,
                      "peak_mem_gb": peak / 1e9,
                      "card_vs_cpu_rel_err": err, "same_argmax": same,
                      "logprobs_row0": y[0].tolist()}
        if name == "int8":
            prof = profile(torch, lambda: pipe.forward(ids),
                           "BERT-base int8 forward, batch 8 x 128")
        del pipe
    return {"phase": "bert", "model": "BERT-base classifier (random "
            "weights from seed 0, 12 layers, full width), 2 labels",
            "batch": [8, 128], "weights_build_s": build_s,
            "linears_per_forward": n_linears, "tol": 2e-2,
            "pipelines": rows}, prof


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from bigdl_tpu_torch.llm import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    built = kernels.build_kernels()
    emit({"phase": "build", "seconds": built,
          "wall_s": time.perf_counter() - t0})

    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (int4_cases(torch, dev, gen) + lowbit_cases(torch, dev, gen)
             + paged_cases(torch, dev, gen) + ragged_cases(torch, dev, gen))
    for c in cases:
        emit(c)
    bad = [c["case"] for c in cases if not c["passed"]]
    check(not bad, f"kernels disagree with their plain versions: {bad}")

    ref = reference_check(torch, dev)
    emit(ref)
    serve, model = serve_7b(torch, dev)
    emit(serve)
    prof = profile_decode(torch, model)
    emit(prof)
    del model
    torch.cuda.empty_cache()
    bert, bert_prof = bert_path(torch, dev)
    emit(bert)
    emit(bert_prof)

    # launches on each path, each read with the counts zeroed just before
    paths = {"serve_7b": serve["launches"]}
    for name, row in bert["pipelines"].items():
        paths[f"bert {name}"] = row["launches"]

    heads = {"int4_matmul": ("qkv_proj M=8 K=4096 N=12288",
                             "bigdl_tpu_torch/csrc/int4_matmul.cu",
                             "bigdl_tpu/llm/kernels/int4_matmul.py:220"),
             "asym_int4_matmul": (
                 "BERT qkvo M=1024", "bigdl_tpu_torch/csrc/lowbit_matmul.cu",
                 "bigdl_tpu/llm/kernels/int4_matmul.py:287"),
             "int8_matmul": (
                 "BERT qkvo M=1024", "bigdl_tpu_torch/csrc/lowbit_matmul.cu",
                 "bigdl_tpu/llm/kernels/int4_matmul.py:334"),
             "paged_attention_decode_stats": (
                 "7B decode", "bigdl_tpu_torch/csrc/paged_attention.cu",
                 "bigdl_tpu/llm/kernels/paged_attention.py:377"),
             "ragged_prefill_attention": (
                 "7B prefill", "bigdl_tpu_torch/csrc/ragged_prefill.cu",
                 "bigdl_tpu/llm/kernels/ragged_prefill.py:189")}
    summary = []
    for name, (case, src, replaces) in heads.items():
        c = next(c for c in cases
                 if c["kernel"] == name and c["case"].startswith(case))
        by_path = {p: n[name] for p, n in paths.items() if n[name]}
        check(by_path, f"{name} never ran on a path: {paths}")
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "case": c["case"], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "passed": all(x["passed"] for x in cases
                          if x["kernel"] == name)})
    report = {"nvidia_smi": smi, "build": built, "cases": cases,
              "reference": ref,
              "serve": serve, "profile": prof, "bert": bert,
              "bert_profile": bert_prof, "kernels": summary}
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(smi, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

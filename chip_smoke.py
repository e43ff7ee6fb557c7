#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bigdl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phase 0  require a CUDA device (exit 2 without one) and print the card's
         name and power limit as ``nvidia-smi`` gives them.
Phase 1  build every CUDA kernel from ``bigdl_tpu_torch/csrc`` (one
         ``nvcc`` per source, all in parallel) and print the seconds.
Phase 2  hold each kernel against its plain PyTorch version on the card
         at the Llama-2-7B shapes of the served path, plus GQA (Hq 32,
         Hkv 8), D=64 and sliding-window shapes; inputs from a seeded
         ``torch.Generator`` on the card. One JSON line per case with the
         errors, the tolerance, the kernel's / plain version's / one
         PyTorch library call's time (CUDA events, median of 25 calls
         run back to back after warm-up) and the bound (bytes over 3.35 TB/s or FLOPs
         over 989 TFLOP/s, whichever is larger).
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

def int4_cases(torch, dev, gen):
    from bigdl_tpu_torch.llm.kernels.int4_matmul import (
        dequant_q4, int4_matmul, int4_matmul_reference)
    out = []
    for m in (8, 512):
        for k, n, what in ((4096, 12288, "qkv_proj"), (4096, 4096, "o_proj"),
                           (4096, 22016, "gate_up_proj"),
                           (11008, 4096, "down_proj"),
                           (4096, 32000, "lm_head")):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            q = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                              dtype=torch.uint8)
            s = torch.empty((k // 32, n), device=dev).uniform_(
                0.001, 0.02, generator=gen)
            got = int4_matmul(x, q, s, out_dtype=torch.float32)
            want = int4_matmul_reference(x, q, s, torch.float32)
            # the bf16-out entry is the one the served path launches
            got16 = int4_matmul(x, q, s)
            want16 = int4_matmul_reference(x, q, s, torch.bfloat16)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            tol = 1e-4 * scale
            err16 = (got16.float() - want16.float()).abs().max().item()
            tol16 = scale * 2.0 ** -7 + tol
            w16 = dequant_q4(q, s, torch.bfloat16)
            nbytes = m * k * 2 + k // 2 * n + k // 32 * n * 4 + m * n * 2
            b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
            out.append({
                "kernel": "int4_matmul", "case": f"{what} M={m} K={k} N={n}",
                "max_abs_err": err, "max_rel_err": err / scale, "tol": tol,
                "tol_rule": "f32 out: 1e-4 * max|plain| (f32 sums, another "
                            "order); bf16 out: that plus 1 bf16 ulp of "
                            "max|plain| (2^-7 of it)",
                "max_abs_err_bf16out": err16, "tol_bf16out": tol16,
                "ms": time_ms(lambda: int4_matmul(x, q, s)),
                "plain_ms": time_ms(
                    lambda: int4_matmul_reference(x, q, s, torch.bfloat16)),
                "library_ms": time_ms(lambda: torch.matmul(x, w16)),
                "library": "torch.matmul(x, dequantized bf16 w)",
                "bound_ms": b_ms, "bound_by": b_by,
                "passed": err <= tol and err16 <= tol16})
            del x, q, s, w16, got, want, got16, want16
    return out


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
              "paged_attention_decode_stats": steps * L,
              "ragged_prefill_attention": n_prefill * L}
    check(all(v > 0 for v in counts.values()), f"a kernel never ran: "
          f"{counts}")
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


def profile_decode(torch, model, steps=3):
    """Where a 7B batch-8 decode step's time goes: the engine's own step
    function (``paged_decode_step_sampled``) on a mid-decode state,
    timed on the host clock to the token fetch, then traced with
    ``torch.profiler`` (CUDA kernel intervals: device busy time, kernel
    launches, time by kernel)."""
    from torch.profiler import ProfilerActivity, profile
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

    with torch.inference_mode():
        for _ in range(2):
            step()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
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
    return {"phase": "profile", "what": "7B decode step, batch 8, lens "
            "33..316", "step_wall_ms": wall,
            "device_busy_ms": busy if kern else None,
            "device_idle_share": (1 - busy / wall) if kern else None,
            "kernel_launches_per_step": len(kern) / steps,
            "top_kernels_ms_per_step": {n: [t / steps, c / steps]
                                        for n, (t, c) in top}}


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
    cases = (int4_cases(torch, dev, gen) + paged_cases(torch, dev, gen)
             + ragged_cases(torch, dev, gen))
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

    heads = {"int4_matmul": ("qkv_proj M=8 K=4096 N=12288",
                             "bigdl_tpu_torch/csrc/int4_matmul.cu",
                             "bigdl_tpu/llm/kernels/int4_matmul.py:220"),
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
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": serve["launches"][name],
            "case": c["case"], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "passed": all(x["passed"] for x in cases
                          if x["kernel"] == name)})
    report = {"nvidia_smi": smi, "cases": cases, "reference": ref,
              "serve": serve, "profile": prof, "kernels": summary}
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

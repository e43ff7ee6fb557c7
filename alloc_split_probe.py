"""Whether a cuBLAS workspace can pin a large freed block of PyTorch's
caching allocator past ``torch.cuda.empty_cache()``, with and without
the split limit that ``chip_smoke.py`` sets (``ALLOC_CONF``) and the
port's ``resolve_device`` sets (``bigdl_tpu_torch.device.SPLIT_LIMIT``),
and what the limit costs a step.

    python3 alloc_split_probe.py [--gib N]
    python3 alloc_split_probe.py --cost [--rounds R]

The first form: for each allocator setting (none; then
``max_split_size_mb:512`` in the environment; then nothing in the
environment and the port's ``resolve_device`` called first, which sets
the limit itself) one process frees an N GiB block (default 40) without
returning it, makes its first cuBLAS call on three new threads and on a
new stream (each takes a workspace from the allocator and holds it for
the life of the process), calls ``empty_cache`` and prints one JSON
line: the setting, the bytes allocated and reserved after it. "None"
starts CUDA before anything of the port runs, so the port cannot set
the limit there.

``--cost``: for each workload, ``R`` rounds (default 2) of four fresh
processes, the settings in the order none, limit, limit, none: the
Llama-2-7B q4_0 decode step at batch 8 as one CUDA graph (the serving
engine's step; synthetic weights from seed 0; 5 warm-up replays, then 40
timed by CUDA events, each followed by the fetch of its tokens) and the
ResNet-50 NHWC bf16 train step at batch 256 (``LocalOptimizer``, phase
15 (b)'s recipe; 3 warm-up and 10 timed steps, CUDA events at dispatch).
Each process prints one JSON line (setting, workload, median and mean
ms, peak allocated and reserved GiB); the lines also go to
``chiprun_out/alloc_split_cost.jsonl``.

Prints the card's name and power limit first. Needs one card; imports
nothing of JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

SETTINGS = ("", "max_split_size_mb:512")
SPLIT = SETTINGS[1]
REPO = os.path.dirname(os.path.abspath(__file__))


def _start(torch, via_port: bool):
    """Start CUDA as the setting says: through the port's
    ``resolve_device`` (which sets the split limit when the environment
    names none), or directly (the allocator starts with what the
    environment says)."""
    if via_port:
        sys.path.insert(0, REPO)
        from bigdl_tpu_torch.device import resolve_device
        resolve_device(None)
    else:
        torch.cuda.init()


def one(gib: int, via_port: bool) -> dict:
    import threading
    import torch
    _start(torch, via_port)
    a = torch.randn(64, 64, device="cuda")
    a @ a                                   # this thread's workspace
    big = torch.empty(gib << 30, dtype=torch.uint8, device="cuda")
    del big                                 # freed, still cached

    def work():
        torch.cuda.set_device(0)
        (a @ a).sum().item()

    for _ in range(3):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        a @ a
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""),
            "via_port": via_port, "freed_gib": gib,
            "allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}


def decode_cost(torch) -> list:
    """ms of each timed replay of the 7B batch-8 decode step's graph."""
    sys.path.insert(0, REPO)
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.graphs import CapturedStep
    from bigdl_tpu_torch.llm.models.llama import LlamaConfig, LlamaForCausalLM
    from bigdl_tpu_torch.llm.serving import bind_decode_step, family_steps
    kernels.build_kernels()
    dev = torch.device("cuda")
    model = LlamaForCausalLM.synthetic_q4(LlamaConfig.llama2_7b(),
                                          device=dev, seed=0)
    cfg = model.config
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
    toks = torch.zeros(B, dtype=torch.int32, device=dev)
    captured = CapturedStep(bind_decode_step(
        model.params, cfg, kp, vp, bt, lens, last, active, toks, page=page,
        fam_step=family_steps(model)["sampled_step"]), dev)
    ms = []
    with torch.inference_mode():
        for i in range(45):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            captured()
            b.record()
            toks.cpu()
            if i >= 5:
                ms.append(a.elapsed_time(b))
    if captured.graph is None:
        raise RuntimeError("the decode step did not run as a graph")
    captured.close()
    return ms


def resnet_cost(torch) -> list:
    """ms of each timed ResNet-50 train step (phase 15 (b)'s recipe)."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.models import resnet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch, warm, timed = 256, 3, 10
    x, y = cs._resnet_batches(warm + timed + 1, batch)
    nn.set_seed(0)
    model = resnet.resnet_imagenet(50, 1000, format="NHWC", device="cuda")
    opt = optim.LocalOptimizer(model, (x, y), nn.ClassNLLCriterion(), batch,
                               optim.Trigger.max_iteration(warm + timed + 1),
                               device="cuda")
    opt.set_optim_method(optim.SGD(0.1, momentum=0.9, weight_decay=1e-4))
    opt.set_input_dtype(torch.bfloat16)
    return cs._event_steps(torch, opt, warm, timed)[0]


def cost(workload: str) -> dict:
    import torch
    _start(torch, False)
    ms = {"decode": decode_cost, "resnet": resnet_cost}[workload](torch)
    return {"alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""),
            "workload": workload, "ms_median": statistics.median(ms),
            "ms_mean": statistics.mean(ms), "ms_each": ms,
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}


def _child(args, conf):
    env = dict(os.environ)
    env.pop("PYTORCH_CUDA_ALLOC_CONF", None)
    if conf:
        env["PYTORCH_CUDA_ALLOC_CONF"] = conf
    r = subprocess.run([sys.executable, os.path.abspath(__file__)] + args,
                       env=env, timeout=900, capture_output=True, text=True)
    if r.returncode:
        sys.stderr.write(r.stderr[-4000:])
        raise SystemExit(f"{args} under {conf!r} exited {r.returncode}")
    return r.stdout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=int, default=40)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--via-port", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-cost", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(one(args.gib, args.via_port)), flush=True)
        return 0
    if args.child_cost:
        print(json.dumps(cost(args.child_cost)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    if not args.cost:
        for conf, port in (("", False), (SPLIT, False), ("", True)):
            print(_child(["--gib", str(args.gib), "--child"]
                         + (["--via-port"] if port else []), conf).strip(),
                  flush=True)
        return 0
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "alloc_split_cost.jsonl"), "w") as f:
        for workload in ("decode", "resnet"):
            for _ in range(args.rounds):
                for conf in SETTINGS + SETTINGS[::-1]:
                    line = _child(["--child-cost", workload], conf).strip()
                    line = line.splitlines()[-1]
                    print(line, flush=True)
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

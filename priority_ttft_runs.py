"""Phase 3c's priority runs of ``chip_smoke.py`` (``_priority_run``: 8
batch requests of Llama-2-7B q4_0 decoding, an interactive 300-token
request after 16 passes) repeated in fresh processes, alternating
between source trees: how the interactive TTFT and the batch rows'
decode gap vary from process to process, and whether they move with
the tree.

    python3 priority_ttft_runs.py [--rounds N] [--out FILE] TREE [TREE ...]

Each round starts one process per TREE, in the order given (a checkout
holding ``chip_smoke.py`` and ``bigdl_tpu_torch/``). A process builds
the tree's kernels, draws Llama-2-7B q4_0 (``synthetic_q4``, seed 0) and
runs the priority run twice with ``priority=True`` and once with
``priority=False``, each checked as ``chip_smoke.py`` checks it, and
prints one JSON line: the tree, each run's interactive TTFT, median and
largest batch token gap, passes and preemptions. Every line also goes
to ``--out`` (default ``chiprun_out/priority_ttft_runs.jsonl``). Needs
one card; imports nothing of JAX.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys


def one(tree: str) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("priority_ttft_runs: no CUDA device")
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from bigdl_tpu_torch.llm import kernels
    from bigdl_tpu_torch.llm.models.llama import LlamaConfig, LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_kernels()
    cfg = LlamaConfig.llama2_7b()
    model = LlamaForCausalLM.synthetic_q4(cfg, device="cuda", seed=0)
    batch = smoke._phase3_prompts(torch, cfg)
    late = torch.randint(0, cfg.vocab_size, (smoke.PRI_LATE,),
                         generator=torch.Generator().manual_seed(12))
    late[0] = 1
    runs = []
    for pri in (True, False, True):
        row = smoke._priority_run(torch, model, batch, late.numpy(), pri,
                                  f"7B priority {'on' if pri else 'off'}")[0]
        runs.append({k: row[k] for k in (
            "priority", "interactive_ttft_ms", "batch_median_gap_ms",
            "passes", "preemptions_total")}
            | {"batch_max_gap_ms": max(row["batch_max_gap_ms"].values())})
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return {"tree": tree, "device": smi, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chiprun_out",
        "priority_ttft_runs.jsonl"))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.trees[0])), flush=True)
        return 0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as out:
        for r in range(args.rounds):
            for tree in args.trees:
                res = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--one",
                     tree], capture_output=True, text=True, timeout=900)
                if res.returncode != 0:
                    print(res.stderr[-4000:], file=sys.stderr)
                    return res.returncode
                line = res.stdout.strip().splitlines()[-1]
                row = json.loads(line) | {"round": r}
                out.write(json.dumps(row) + "\n")
                out.flush()
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

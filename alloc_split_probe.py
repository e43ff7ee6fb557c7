"""Whether a cuBLAS workspace can pin a large freed block of PyTorch's
caching allocator past ``torch.cuda.empty_cache()``, with and without
the split limit that ``chip_smoke.py`` sets (``ALLOC_CONF``).

    python3 alloc_split_probe.py [--gib N]

For each allocator setting (none, then ``max_split_size_mb:512``) one
process frees an N GiB block (default 40) without returning it, makes
its first cuBLAS call on three new threads and on a new stream (each
takes a workspace from the allocator and holds it for the life of the
process), calls ``empty_cache`` and prints one JSON line: the setting,
the bytes allocated and reserved after it. Prints the card's name and
power limit first. Needs one card; imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

SETTINGS = ("", "max_split_size_mb:512")


def one(gib: int) -> dict:
    import threading
    import torch
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
            "freed_gib": gib,
            "allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=int, default=40)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(one(args.gib)), flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    for conf in SETTINGS:
        env = dict(os.environ)
        env.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        if conf:
            env["PYTORCH_CUDA_ALLOC_CONF"] = conf
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--gib", str(args.gib), "--child"], env=env,
                       check=True, timeout=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())

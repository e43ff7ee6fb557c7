#!/usr/bin/env python3
"""Time the q4_0 dequant matmul (``int4_matmul``) of one checkout of the
port at small M, on the Llama-2-7B and Mistral-7B decode shapes.

    python3 decode_matmul_timing.py <checkout>

``<checkout>`` is a directory that holds ``bigdl_tpu_torch`` and
``chip_smoke.py`` (this repository, or an older commit unpacked with
``git archive``); the kernel the route rule takes there is held to the
plain version and timed with ``chip_smoke.time_ms`` (CUDA events, median
of 25), bf16 out as served. Prints one JSON object: ``{"<shape> M=<m>":
[ms, route, within 2e-5 of max|y|]}``. Run it on one card from two
checkouts in turns (parent, change, change, parent) to compare them:
``chip_smoke.py`` of a commit times only the shapes its own paths run.
Needs a CUDA device.
"""

import json
import os
import sys

SHAPES = ((4096, 6144, "Mistral qkv_proj"), (4096, 4096, "Mistral o_proj"),
          (4096, 28672, "Mistral gate_up_proj"),
          (14336, 4096, "Mistral down_proj"), (4096, 12288, "7B qkv_proj"),
          (4096, 22016, "7B gate_up_proj"), (11008, 4096, "7B down_proj"),
          (4096, 32000, "7B lm_head"))


def main(root: str) -> int:
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("decode_matmul_timing: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import time_ms
    from bigdl_tpu_torch.llm import kernels as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for m in (1, 2):
        for k, n, what in SHAPES:
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            q = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                              dtype=torch.uint8)
            s = torch.empty((k // 32, n), device=dev).uniform_(
                0.001, 0.02, generator=gen)
            want = K.int4_matmul_reference(x, q, s, torch.float32)
            got = K.int4_matmul(x, q, s, out_dtype=torch.float32)
            ok = ((got - want).abs().max().item()
                  <= 2e-5 * want.abs().max().item())
            out[f"{what} M={m}"] = (time_ms(lambda: K.int4_matmul(x, q, s)),
                                    K.matmul_route(m, n), ok)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(os.path.abspath(sys.argv[1])))

"""The port's tensor, sequence and pipeline parallelism held to the JAX
package on the CPU.

Gloo ranks are started once for the module at W = 2 and at W = 4 (one
``python -c`` script a rank, importing only ``torch`` and
``bigdl_tpu_torch``; rank 0's store is bound at ``127.0.0.1:0`` and its
port handed on through a file). They read their inputs and the JAX
models' weights from an ``.npz`` made here with numpy from a seed, run
every case, and write what they computed to one ``.npz`` a rank; the
comparisons run here, against the JAX package on the 8-device CPU mesh:

- ``ring_attention`` and ``ulysses_attention``, causal and not, against
  ``tests/test_parallel.py``'s cases and its numpy reference (rtol and
  atol 2e-4, as there), the ring also on a ``data`` x ``seq`` mesh;
- the GPipe forward and the training losses (``remat``) against the JAX
  ``PipelineModule`` at the same stage count (1e-5 forward; losses rtol
  1e-4, atol 1e-5, as ``test_parallel.py`` holds JAX to one device);
- ``param_shardings``'s specs equal JAX's on the same rules, and each
  rank's shard of ``shard_along`` / ``constrain`` / ``replicated`` the
  block JAX's ``NamedSharding`` puts on its device;
- llama ``shard`` + ``generate`` on the q4_0 tiny config of
  ``tests/test_llm.py``'s fused-projection test: tokens equal the JAX
  sharded ``generate``'s (f32 weights and cache, so near-ties cannot
  flip) at tp 2 and 4, the fused q/k/v boundary at and inside q;
- the f32 ring prefill's logits, its cache and the next decode step
  within 1e-4 of the dense prefill, as ``tests/test_llm.py`` holds JAX;
- the expert-parallel forward of ``tiny_moe`` on an ``{"ep": 2,
  "model": 2}`` mesh within 2e-2 of the unsharded one (the experts run
  in bf16 as in the JAX package, and their sum is split over ranks);
- GPT-NeoX ``shard`` + ``generate`` equal to the JAX sharded model's
  tokens (q4_0 at tp 2; f32 at tp 4, where a head's 16 rows cannot hold
  a q4_0 group).

The ranks have their own 180 s limit: past it the test fails."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bigdl_tpu import parallel as jpar
from bigdl_tpu.llm.models import gptneox as jn
from bigdl_tpu.llm.models import llama as jl
from bigdl_tpu.optim.optim_method import SGD as JSGD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
STEPS = 10

TREE = '''
def tree(flat, prefix):
    out = {}
    for k in flat.files:
        if k.startswith(prefix + "/"):
            node = out
            *path, leaf = k[len(prefix) + 1:].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = flat[k]
    return out
'''

RANK = TREE + r'''
import datetime, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
wait = datetime.timedelta(seconds=90)
portfile = os.path.join(work, f"port{world}")
if rank == 0:
    store = dist.TCPStore("127.0.0.1", 0, world, True, timeout=wait,
                          wait_for_workers=False)
    with open(portfile + ".tmp", "w") as f:
        f.write(str(store.port))
    os.replace(portfile + ".tmp", portfile)
else:
    t0 = time.time()
    while not os.path.exists(portfile):
        if time.time() - t0 > 90:
            raise SystemExit("rank 0 gave no port")
        time.sleep(0.02)
    store = dist.TCPStore("127.0.0.1", int(open(portfile).read()), world,
                          False, timeout=wait)
dist.init_process_group("gloo", store=store, rank=rank, world_size=world)

from bigdl_tpu_torch import optim
from bigdl_tpu_torch.llm.convert import params_from_numpy
from bigdl_tpu_torch.llm.models import gptneox as tn, llama as tl
from bigdl_tpu_torch.parallel import (
    PipelineModule, constrain, create_mesh, make_pipeline_train_step,
    param_shardings, replicated, ring_attention, shard_along,
    split_microbatches, ulysses_attention)
from bigdl_tpu_torch.parallel.mesh import P

inp = np.load(os.path.join(work, "inputs.npz"))
T = lambda k: torch.from_numpy(inp[k])
out = {}

seq = create_mesh({"seq": world})
for causal in (False, True):
    q, k, v = (T(f"ring/{n}") for n in "qkv")
    out[f"ring/{causal}"] = ring_attention(
        q, k, v, seq, causal=causal, batch_axis=None).numpy()
    q, k, v = (T(f"uly/{n}") for n in "qkv")
    out[f"uly/{causal}"] = ulysses_attention(
        q, k, v, seq, causal=causal, batch_axis=None).numpy()
if world == 4:
    q, k, v = (T(f"ring2d/{n}") for n in "qkv")
    out["ring2d"] = ring_attention(q, k, v, create_mesh(
        {"data": 2, "seq": 2}), causal=True).numpy()

pipe_mesh = create_mesh({"pipe": world})
stage = lambda p, x: torch.tanh(x @ p["w"].T + p["b"])
pipe = PipelineModule(stage, world, pipe_mesh)
out["pipe/fwd"] = pipe(pipe.place_params(
    {"w": T("pipe/w"), "b": T("pipe/b")}), T("pipe/xs")).numpy()
pipe = PipelineModule(stage, world, pipe_mesh, remat=True)
sgd = optim.SGD(learning_rate=0.2)
params = pipe.place_params({"w": T("train/w"), "b": T("train/b")})
opt_state = sgd.init_state(params)
step = make_pipeline_train_step(
    pipe, lambda o, t: torch.mean((o - t) ** 2), sgd, lr=0.2)
mx, mt = split_microbatches([T("train/x"), T("train/t")], 8)
losses = []
for _ in range(10):
    params, opt_state, loss = step(params, opt_state, mx, mt)
    losses.append(float(loss))
out["pipe/losses"] = np.array(losses)

model_mesh = create_mesh({"model": world})
x = T("place/x")
dt = shard_along(model_mesh, "model", 0).place(x)
out["place/rows"] = dt.to_local().numpy()
out["place/cols"] = constrain(dt, P(None, "model")).to_local().numpy()
out["place/whole"] = constrain(dt, replicated(model_mesh)).to_local().numpy()
sh = param_shardings(
    {"fc_1": {"weight": torch.zeros(8, 6), "bias": torch.zeros(8)},
     "fc_2": {"weight": torch.zeros(5, 8)}, "stack": [torch.zeros(4, 3)]},
    model_mesh, [("fc_1/weight", P("model", None)), ("bias", P("model")),
                 ("fc_2", P(None, "model")), (r"\[0\]", P("model"))])
for name, s in (("fc_1/weight", sh["fc_1"]["weight"]),
                ("fc_1/bias", sh["fc_1"]["bias"]),
                ("fc_2/weight", sh["fc_2"]["weight"]),
                ("stack", sh["stack"][0])):
    out[f"specs/{name}"] = np.array([str(a) for a in s.spec])

def llama(cfg_key, params_key):
    cfg = tl.LlamaConfig(**eval(str(inp[cfg_key])))
    return cfg, params_from_numpy(tree(inp, params_key), "cpu")

cfg, p = llama("tp/cfg", "tp/p")
ids = inp["tp/ids"]
out["tp/tokens"] = tl.LlamaForCausalLM(
    cfg, p, 32, torch.float32, device="cpu").shard(model_mesh).generate(
        ids, max_new_tokens=6)

cfg, p = llama("ring_lm/cfg", "ring_lm/p")
m = tl.LlamaForCausalLM(cfg, p, 64, torch.float32, device="cpu")
ids = inp["ring_lm/ids"]
dense_logits, dense_cache = m(ids)
m.sequence_parallel(seq)
ring_logits, ring_cache = m(ids)
nxt = ring_logits[:, -1].argmax(-1).to(torch.int32)[:, None]
pos = torch.full((2, 1), 32)
out["ring_lm/dense"] = dense_logits.numpy()
out["ring_lm/ring"] = ring_logits.numpy()
for kv in ("k", "v"):
    out[f"ring_lm/dense_{kv}"] = dense_cache[kv].numpy()
    out[f"ring_lm/ring_{kv}"] = ring_cache[kv].numpy()
out["ring_lm/next_ring"] = tl.forward(m.params, cfg, nxt, ring_cache,
                                      pos)[0].numpy()
out["ring_lm/next_dense"] = tl.forward(m.params, cfg, nxt, dense_cache,
                                       pos)[0].numpy()

if world == 4:
    cfg, p = llama("moe/cfg", "moe/p")
    toks = torch.from_numpy(inp["moe/ids"])
    pos4 = torch.arange(4).expand(2, 4)
    whole = tl.forward(p, cfg, toks, tl.init_cache(
        cfg, 2, 8, torch.float32, "cpu"), pos4)[0]
    sp, scfg = tl.shard_params(p, cfg, create_mesh({"ep": 2, "model": 2}),
                               ep_axis="ep")
    out["moe/whole"] = whole.numpy()
    out["moe/shard"] = tl.forward(sp, scfg, toks, tl.init_cache(
        scfg, 2, 8, torch.float32, "cpu"), pos4)[0].numpy()

ncfg = tn.GptNeoXConfig(**eval(str(inp["neox/cfg"])))
key = "neox/q4" if world == 2 else "neox/f32"
out["neox/tokens"] = tn.GptNeoXForCausalLM(
    ncfg, params_from_numpy(tree(inp, key), "cpu"), 32, torch.float32,
    device="cpu").shard(model_mesh).generate(inp["neox/ids"],
                                             max_new_tokens=5)

np.savez(os.path.join(work, f"out_{world}_{rank}.npz"), **out)
dist.destroy_process_group()
'''


def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        elif np.asarray(v).dtype.kind in "biuf":
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _ref_attention(q, k, v, causal=False):
    d = q.shape[-1]
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    if causal:
        s = q.shape[1]
        logits = np.where(np.tril(np.ones((s, s), bool))[None, None],
                          logits, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", p, v)


def _tp_cfg():
    return dataclasses.replace(jl.LlamaConfig.tiny(), hidden_size=128,
                               intermediate_size=256)


def _inputs():
    rs = np.random.RandomState(0)
    inp = {}
    for name, shape in (("ring", (2, 32, 4, 8)), ("uly", (2, 16, 8, 4)),
                        ("ring2d", (4, 16, 2, 4))):
        for n in "qkv":
            inp[f"{name}/{n}"] = rs.randn(*shape).astype(np.float32)
    inp["place/x"] = rs.randn(8, 12).astype(np.float32)
    inp["pipe/w"] = rs.randn(4, 6, 6).astype(np.float32) * 0.3
    inp["pipe/b"] = rs.randn(4, 6).astype(np.float32) * 0.1
    inp["pipe/xs"] = rs.randn(8, 2, 6).astype(np.float32)
    inp["train/w"] = rs.randn(4, 6, 6).astype(np.float32) * 0.4
    inp["train/b"] = rs.randn(4, 6).astype(np.float32) * 0.1
    inp["train/x"] = rs.randn(32, 6).astype(np.float32)
    inp["train/t"] = np.tanh(inp["train/x"] @ rs.randn(6, 6).astype(
        np.float32))
    for key, cfg, quant in (("tp", _tp_cfg(), True),
                            ("ring_lm", jl.LlamaConfig.tiny(), False),
                            ("moe", jl.LlamaConfig.tiny_moe(), False)):
        p = jl.init_params(cfg, 0, dtype=jnp.float32)
        if quant:
            p = jl.quantize_params(p, "sym_int4")
        inp[f"{key}/cfg"] = np.array(repr(dataclasses.asdict(cfg)))
        _flat(jax.tree_util.tree_map(np.asarray, p), f"{key}/p", inp)
    inp["tp/ids"] = np.array([[4, 8, 15, 16]], np.int32)
    inp["ring_lm/ids"] = rs.randint(0, 256, (2, 32)).astype(np.int32)
    inp["moe/ids"] = np.array([[1, 2, 3, 4]] * 2, np.int32)
    ncfg = jn.GptNeoXConfig.tiny()
    inp["neox/cfg"] = np.array(repr(dataclasses.asdict(ncfg)))
    npar = jn.init_params(ncfg, 0, dtype=jnp.float32)
    for key, p in (("neox/f32", npar),
                   ("neox/q4", jn.quantize_params(npar, "sym_int4"))):
        _flat(jax.tree_util.tree_map(np.asarray, p), key, inp)
    inp["neox/ids"] = rs.randint(0, 256, (2, 5)).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, the gloo ranks at W = 2 and W = 4 run once on them,
    and what each wrote: ``{W: [rank 0's, rank 1's, ...]}``."""
    work = str(tmp_path_factory.mktemp("parallel"))
    inp = _inputs()
    np.savez(os.path.join(work, "inputs.npz"), **inp)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK",
                                "LOCAL_RANK", "BIGDL_TPU_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [(w, r, subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(w), work],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)) for w in WORLDS for r in range(w)]
    errs = {}
    try:
        for w, r, p in procs:
            errs[w, r] = p.communicate(timeout=180)[1]
    except subprocess.TimeoutExpired:
        pytest.fail("the gloo ranks did not finish within 180 s")
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for w, r, p in procs:
        assert p.returncode == 0, f"W={w} rank {r}:\n{errs[w, r][-4000:]}"
    outs = {w: [dict(np.load(os.path.join(work, f"out_{w}_{r}.npz")))
                for r in range(w)] for w in WORLDS}
    return inp, outs


def _every_rank(outs, key):
    first = outs[0][key]
    for o in outs[1:]:
        np.testing.assert_array_equal(o[key], first, err_msg=key)
    return first


class _NpzView(dict):
    """The inputs read through ``tree`` as the ranks read the ``.npz``."""

    @property
    def files(self):
        return list(self)


def _tree(inp, prefix):
    """The JAX tree ``prefix`` of the inputs, as the ranks rebuild it."""
    ns = {}
    exec(TREE, ns)
    return jax.tree_util.tree_map(jnp.asarray,
                                  ns["tree"](_NpzView(inp), prefix))


def _jax_pipe(inp, world, devices, train):
    mesh = jpar.create_mesh({"pipe": world})

    def stage(p, xb):
        return jnp.tanh(xb @ p["w"].T + p["b"])

    if not train:
        pipe = jpar.PipelineModule(stage, world, mesh)
        p = pipe.place_params({"w": jnp.asarray(inp["pipe/w"][:world]),
                               "b": jnp.asarray(inp["pipe/b"][:world])})
        return np.asarray(pipe(p, inp["pipe/xs"]))
    pipe = jpar.PipelineModule(stage, world, mesh, remat=True)
    p = pipe.place_params({"w": jnp.asarray(inp["train/w"][:world]),
                           "b": jnp.asarray(inp["train/b"][:world])})
    sgd = JSGD(learning_rate=0.2)
    opt = sgd.init_state(p)
    step = jpar.make_pipeline_train_step(
        pipe, lambda o, t: jnp.mean((o - t) ** 2), sgd, lr=0.2)
    mx = jpar.split_microbatches(jnp.asarray(inp["train/x"]), 8)
    mt = jpar.split_microbatches(jnp.asarray(inp["train/t"]), 8)
    losses = []
    for _ in range(STEPS):
        p, opt, loss = step(p, opt, mx, mt)
        losses.append(float(loss))
    return np.array(losses)


CASES = ["ring", "ulysses", "pipe_forward", "pipe_training",
         "param_shardings", "placements", "shard_generate", "ring_prefill",
         "neox_shard"]
# the meshes of two axes need four ranks
FOUR = ["ring2d", "ep_forward"]


@pytest.mark.parametrize("case,world", [(c, w) for c in CASES
                                        for w in WORLDS]
                         + [(c, 4) for c in FOUR])
def test_parallel_equals_the_jax_package(ranks, devices, case, world):
    inp, all_outs = ranks
    outs = all_outs[world]
    if case in ("ring", "ulysses"):
        pre = "ring" if case == "ring" else "uly"
        for causal in (False, True):
            got = _every_rank(outs, f"{pre}/{causal}")
            q, k, v = (inp[f"{pre}/{n}"] for n in "qkv")
            np.testing.assert_allclose(got, _ref_attention(q, k, v, causal),
                                       rtol=2e-4, atol=2e-4)
            mesh = jpar.create_mesh({"seq": world})
            fn = jpar.ring_attention if case == "ring" else \
                jpar.ulysses_attention
            want = np.asarray(fn(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), mesh, axis="seq",
                                 causal=causal, batch_axis=None))
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    elif case == "ring2d":
        got = _every_rank(outs, "ring2d")
        q, k, v = (inp[f"ring2d/{n}"] for n in "qkv")
        np.testing.assert_allclose(got, _ref_attention(q, k, v, True),
                                   rtol=2e-4, atol=2e-4)
    elif case == "pipe_forward":
        got = _every_rank(outs, "pipe/fwd")
        np.testing.assert_allclose(
            got, _jax_pipe(inp, world, devices, False), rtol=1e-5,
            atol=1e-5)
    elif case == "pipe_training":
        got = _every_rank(outs, "pipe/losses")
        want = _jax_pipe(inp, world, devices, True)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        assert got[-1] < got[0] * 0.9, "did not learn"
    elif case == "param_shardings":
        mesh = jpar.create_mesh({"model": world})
        P = jax.sharding.PartitionSpec
        sh = jpar.param_shardings(
            {"fc_1": {"weight": jnp.zeros((8, 6)), "bias": jnp.zeros(8)},
             "fc_2": {"weight": jnp.zeros((5, 8))},
             "stack": [jnp.zeros((4, 3))]},
            mesh, [("fc_1/weight", P("model", None)), ("bias", P("model")),
                   ("fc_2", P(None, "model")), (r"\[0\]", P("model"))])
        for name, s in (("fc_1/weight", sh["fc_1"]["weight"]),
                        ("fc_1/bias", sh["fc_1"]["bias"]),
                        ("fc_2/weight", sh["fc_2"]["weight"]),
                        ("stack", sh["stack"][0])):
            got = list(_every_rank(outs, f"specs/{name}"))
            assert got == [str(a) for a in s.spec], name
    elif case == "placements":
        # each rank's DTensor shard is the rows / columns JAX's
        # NamedSharding puts on its device; replicated is the whole
        x = inp["place/x"]
        mesh = jpar.create_mesh({"model": world})
        P = jax.sharding.PartitionSpec
        for key, spec in (("rows", P("model", None)),
                          ("cols", P(None, "model"))):
            placed = jax.device_put(x, jax.sharding.NamedSharding(mesh,
                                                                  spec))
            for r, o in enumerate(outs):
                shard = next(s for s in placed.addressable_shards
                             if s.device == mesh.devices[r])
                np.testing.assert_array_equal(o[f"place/{key}"],
                                              np.asarray(shard.data))
        for o in outs:
            np.testing.assert_array_equal(o["place/whole"], x)
    elif case == "shard_generate":
        got = _every_rank(outs, "tp/tokens")
        cfg = _tp_cfg()
        q = _tree(inp, "tp/p")
        mesh = jax.sharding.Mesh(np.asarray(devices[:world]), ("model",))
        want = jl.LlamaForCausalLM(
            cfg, q, max_cache_len=32, cache_dtype=jnp.float32).shard(
                mesh).generate(inp["tp/ids"], max_new_tokens=6)
        np.testing.assert_array_equal(got, np.asarray(want))
    elif case == "ring_prefill":
        o = outs[0]
        for a, b in (("dense", "ring"), ("dense_k", "ring_k"),
                     ("dense_v", "ring_v"), ("next_dense", "next_ring")):
            ring = _every_rank(outs, f"ring_lm/{b}")
            np.testing.assert_allclose(ring, o[f"ring_lm/{a}"], rtol=1e-4,
                                       atol=1e-4, err_msg=b)
        cfg = jl.LlamaConfig.tiny()
        jm = jl.LlamaForCausalLM(cfg, _tree(inp, "ring_lm/p"),
                                 max_cache_len=64, cache_dtype=jnp.float32)
        jm.sequence_parallel(jpar.create_mesh({"seq": world}))
        want, _ = jm(jnp.asarray(inp["ring_lm/ids"]))
        np.testing.assert_allclose(o["ring_lm/ring"], np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    elif case == "ep_forward":
        got = _every_rank(outs, "moe/shard")
        whole = outs[0]["moe/whole"]
        scale = np.abs(whole).max()
        assert np.abs(got - whole).max() <= 2e-2 * scale
        cfg = jl.LlamaConfig.tiny_moe()
        want, _ = jl.forward(_tree(inp, "moe/p"), cfg,
                             jnp.asarray(inp["moe/ids"]),
                             jl.init_cache(cfg, 2, 8, dtype=jnp.float32),
                             jnp.broadcast_to(jnp.arange(4), (2, 4)))
        assert np.abs(whole - np.asarray(want)).max() <= 2e-2 * scale
    elif case == "neox_shard":
        got = _every_rank(outs, "neox/tokens")
        cfg = jn.GptNeoXConfig.tiny()
        key = "neox/q4" if world == 2 else "neox/f32"
        mesh = jax.sharding.Mesh(np.asarray(devices[:world]), ("model",))
        want = jn.GptNeoXForCausalLM(
            cfg, _tree(inp, key), max_cache_len=32,
            cache_dtype=jnp.float32).shard(mesh).generate(
                inp["neox/ids"], max_new_tokens=5)
        np.testing.assert_array_equal(got, np.asarray(want))

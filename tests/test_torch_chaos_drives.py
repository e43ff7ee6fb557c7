"""The port's training, prefix-cache and host-tier chaos drives
(``bigdl_tpu_torch.llm.chaos``: ``run_chaos``, ``run_kvcache_chaos``,
``run_kvtier_chaos``) against the JAX drives of ``tools/chaos_check.py``
on the same seed, on the CPU: each passes its own contract, and the two
records have the same keys and outcome. The armed plans are the same
seeded rules in both packages and the engines evict, spill and fetch
alike, so the fired events and the counts are equal too; the losses are
each package's own (the weights come from each package's init stream)."""

import json

import pytest

from tools import chaos_check as jchaos

from bigdl_tpu_torch.llm import chaos


@pytest.fixture(autouse=True)
def _keep_jax_init_stream():
    from bigdl_tpu.nn.module import FORWARD_RNG, RNG
    keys = (RNG._key, FORWARD_RNG._key)
    yield
    RNG._key, FORWARD_RNG._key = keys


# the record keys each package computes from its own weights
OWN = {"clean_loss", "injected_loss"}


@pytest.mark.parametrize("name", ["chaos", "kvcache", "kvtier"])
def test_drive_equals_the_jax_drive(name):
    run = {"chaos": "run_chaos", "kvcache": "run_kvcache_chaos",
           "kvtier": "run_kvtier_chaos"}[name]
    got = getattr(chaos, run)(seed=1, device="cpu")
    want = getattr(jchaos, run)(seed=1)
    assert set(got) == set(want)
    assert got["match"] is want["match"] is True
    assert got["events_fired"]
    for k in set(want) - OWN:
        assert got[k] == want[k], k
    if name == "chaos":
        assert got["clean_loss"] == pytest.approx(got["injected_loss"],
                                                  rel=1e-4)


def test_drive_flags(monkeypatch, capsys):
    """``--chaos`` runs the smoke training run unless ``--full`` and takes
    ``--events``; ``--kvcache`` and ``--kvtier`` take the seed and the
    device; the real ``--kvtier`` drive prints its record."""
    calls = []
    for name in ("chaos", "kvcache"):
        monkeypatch.setitem(chaos.DRIVES, name,
                            lambda **kw: calls.append(kw) or {"match": True})
    assert chaos.main(["--chaos", "--device", "cpu"]) == 0
    assert chaos.main(["--chaos", "--full", "--events", "3"]) == 0
    assert chaos.main(["--kvcache", "--seed", "2"]) == 0
    assert calls == [dict(seed=0, device="cpu", smoke=True, events=5),
                     dict(seed=0, device=None, smoke=False, events=3),
                     dict(seed=2, device=None)]
    capsys.readouterr()
    assert chaos.main(["--kvtier", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["drive"] == "kvtier" and out["ok"] and out["clean_fetches"]

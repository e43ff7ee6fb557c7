"""The port's Chronos (``bigdl_tpu_torch.chronos``) held to the JAX
package's on the CPU, on the same numpy inputs from a seed.

- ``TSDataset``: every verb gives the JAX frame, and ``roll`` its arrays
  bit for bit (one id, several ids, a horizon list, too short a
  series); a one-id roll is a view of the frame's values. The metrics
  equal.
- The forecasters (TCN, Seq2Seq, LSTM, N-BEATS, Autoformer) with the
  JAX model's weights carried in: the forward within 1e-5; ``fit`` at
  dropout 0 for two epochs (the JAX batches): each weight within 1e-4
  of the largest, the last loss within 1e-4 (f32 sums in another
  order). ``save`` / ``load`` round-trips bit for bit. Dropout > 0 by
  contract: the keep rate of each package within 0.01 of 1 - p, and the
  port deterministic on its seed.
- Autoformer: the decomposition within 1e-6 and the auto-correlation
  within 1e-5, with the chosen delays equal to JAX's.
- Detectors: ``AEDetector`` from the JAX initial weights gives the same
  anomaly indexes and its threshold within 1e-5; ``ThresholdDetector``
  and ``DBScanDetector`` give the same indexes.
- DPGAN: one step with ``dp`` off and on, fed the JAX step's latents and
  noise, gives its parameters within 1e-5; ``generate`` by contract.
- ``AutoTSEstimator``: the same trial configs and the same best lookback
  on a series only the long lookback can predict.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import bigdl_tpu.chronos.forecaster as JF
import bigdl_tpu.nn as jnn
from bigdl_tpu.chronos import metric as jmetric
from bigdl_tpu.chronos.autots import auto_ts as jauto_ts
from bigdl_tpu.chronos.data import TSDataset as JTSDataset
from bigdl_tpu.chronos.detector import (AEDetector as JAEDetector,
                                        DBScanDetector as JDBScanDetector,
                                        ThresholdDetector as JThreshold)
from bigdl_tpu.chronos.forecaster.autoformer import (
    _auto_correlation as j_auto_correlation, _series_decomp as j_decomp)
from bigdl_tpu.chronos.simulator import DPGANSimulator as JDPGAN
from bigdl_tpu.nn.module import set_seed as jset_seed
from bigdl_tpu.orca.automl import hp as jhp

import bigdl_tpu_torch.chronos.forecaster as TF
from bigdl_tpu_torch.chronos import metric as tmetric
from bigdl_tpu_torch.chronos.autots import auto_ts as tauto_ts
from bigdl_tpu_torch.chronos.data import TSDataset, roll_windows
from bigdl_tpu_torch.chronos.detector import (AEDetector, DBScanDetector,
                                              ThresholdDetector)
from bigdl_tpu_torch.chronos.forecaster.autoformer import (
    _auto_correlation, _delays, _series_decomp)
from bigdl_tpu_torch.chronos.simulator import DPGANSimulator
from bigdl_tpu_torch.orca.automl import hp

CPU = "cpu"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sine_df(n=120, ids=None, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(n)
    base = {"dt": pd.date_range("2025-01-03", periods=n, freq="h"),
            "value": np.sin(t * 0.3) + 0.1 * rs.randn(n),
            "extra": np.cos(t * 0.3)}
    if ids is None:
        return pd.DataFrame(base)
    parts = []
    for k, i in enumerate(ids):
        d = pd.DataFrame(base)
        d["id"] = i
        d["value"] += k
        parts.append(d.iloc[:n - 7 * k])        # ids of unequal length
    return pd.concat(parts, ignore_index=True)


# ---------------------------------------------------------------------------
# TSDataset and the metrics
# ---------------------------------------------------------------------------

class _Std:
    """A numpy StandardScaler (``scale`` takes any fit/transform object)."""

    def fit(self, v):
        self.mean_, self.scale_ = v.mean(0), v.std(0)

    def transform(self, v):
        return (v - self.mean_) / self.scale_

    def inverse_transform(self, v):
        return v * self.scale_ + self.mean_


def _holey(df):
    df = df.copy()
    df.loc[[3, 4, 17], "value"] = np.nan
    df.loc[[0, 30], "extra"] = np.nan
    return df


TS_CASES = {
    "impute_last": lambda ts: ts.impute("last"),
    "impute_const": lambda ts: ts.impute("const", 2.5),
    "impute_linear": lambda ts: ts.impute("linear"),
    "deduplicate": lambda ts: ts.deduplicate(),
    "resample": lambda ts: ts.impute("linear").resample("3h"),
    "scale_unscale": lambda ts: ts.impute("last").scale(_Std()).unscale(),
    "dt_features": lambda ts: ts.gen_dt_feature(
        ["HOUR", "DAY", "MONTH", "WEEKDAY", "MINUTE", "DAYOFYEAR",
         "WEEKOFYEAR", "IS_WEEKEND"]),
    "roll": lambda ts: ts.impute("last").roll(12, 3),
    "roll_horizon_list": lambda ts: ts.impute("last").roll(10, [1, 4, 6]),
    "roll_targets_only": lambda ts: ts.impute("last").roll(
        8, 2, feature_col=[], target_col="value"),
    "roll_too_short": lambda ts: ts.roll(200, 3),
}


def _ts_run(cls, case, ids):
    df = _holey(_sine_df(ids=ids))
    if case == "deduplicate":
        df = pd.concat([df, df.iloc[5:9]], ignore_index=True)
    ts = cls.from_pandas(df, "dt", "value", "extra",
                         id_col="id" if ids else None)
    TS_CASES[case](ts)
    return ts


@pytest.mark.parametrize("ids", [None, ["b", "a"]], ids=["one_id", "two_ids"])
@pytest.mark.parametrize("case", list(TS_CASES))
def test_tsdataset_verbs_equal_jax(case, ids):
    j, t = _ts_run(JTSDataset, case, ids), _ts_run(TSDataset, case, ids)
    pd.testing.assert_frame_equal(t.to_pandas(), j.to_pandas())
    assert t.feature_cols == j.feature_cols
    assert (t.get_feature_num(), t.get_target_num()) == \
        (j.get_feature_num(), j.get_target_num())
    if case.startswith("roll"):
        (jx, jy), (tx, ty) = j.to_numpy(), t.to_numpy()
        for a, b in ((tx, jx), (ty, jy)):      # bit for bit
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
        assert (t.lookback, t.horizon) == (j.lookback, j.horizon)


def test_split_unscale_numpy_and_view():
    parts = [cls.from_pandas(_sine_df(100), "dt", "value", "extra",
                             with_split=True, val_ratio=0.2,
                             test_ratio=0.1)
             for cls in (JTSDataset, TSDataset)]
    for j, t in zip(*parts):
        pd.testing.assert_frame_equal(t.df, j.df)
    j, t = (p[0].scale(_Std()).roll(8, 2) for p in parts)
    y = np.random.RandomState(1).randn(4, 2, 1)
    np.testing.assert_array_equal(t.unscale_numpy(y), j.unscale_numpy(y))
    vals = t.df[["value", "extra"]].to_numpy(np.float32)
    x, yy = roll_windows(vals, vals[:, :1], 8, 2)
    assert np.shares_memory(x, vals) and np.shares_memory(yy, vals)
    np.testing.assert_array_equal(x, t.to_numpy()[0])


@pytest.mark.parametrize("name", list(jmetric.METRICS))
def test_metrics_equal_jax(name):
    rs = np.random.RandomState(2)
    a, b = rs.randn(6, 3, 2), rs.randn(6, 3, 2)
    assert tmetric.evaluate(a, b, [name]) == jmetric.evaluate(a, b, [name])


# ---------------------------------------------------------------------------
# Forecasters
# ---------------------------------------------------------------------------

L, H, C = 12, 3, 2
FORECASTERS = {
    "tcn": ("TCNForecaster", dict(
        past_seq_len=L, future_seq_len=H, input_feature_num=C,
        output_feature_num=1, num_channels=(4, 5, 5), dropout=0.0,
        lr=5e-3)),
    "seq2seq": ("Seq2SeqForecaster", dict(
        past_seq_len=L, future_seq_len=H, input_feature_num=C,
        output_feature_num=1, lstm_hidden_dim=6, lstm_layer_num=2,
        lr=5e-3)),
    "lstm": ("LSTMForecaster", dict(
        past_seq_len=L, future_seq_len=H, input_feature_num=C,
        output_feature_num=1, hidden_dim=6, layer_num=2, dropout=0.0,
        lr=5e-3)),
    "nbeats": ("NBeatsForecaster", dict(
        past_seq_len=L, future_seq_len=H, nbeats_units=8, num_blocks=2,
        lr=5e-3)),
    "autoformer": ("AutoformerForecaster", dict(
        past_seq_len=L, future_seq_len=H, input_feature_num=C,
        output_feature_num=C, d_model=8, lr=5e-3)),
}


# The Autoformer's embedding and second feed-forward biases add a
# constant along time, which the series decomposition that follows takes
# out exactly (and the auto-correlation's softmax is shift-invariant), so
# their exact gradient is zero. Both packages step them by Adam's
# normalised rounding noise, up to lr a step; they are held to that, and
# ``test_zero_gradient_biases`` shows the gradient is zero.
ZERO_GRAD = {"autoformer": ("embed_b", "ff2_b")}


def _pair(name, **over):
    """The JAX forecaster and the port's, carrying the JAX weights."""
    cls, kw = FORECASTERS[name]
    kw = {**kw, **over}
    j = getattr(JF, cls)(**kw)
    t = getattr(TF, cls)(**kw, device=CPU)
    t.model.load_parameters_dict(_np(j.model.parameters_dict()))
    return j, t


def _data(name, n=70, seed=3):
    _, kw = FORECASTERS[name]
    c_in = kw.get("input_feature_num", 1)
    c_out = kw.get("output_feature_num", 1)
    rs = np.random.RandomState(seed)
    s = np.sin(np.arange(n + L + H)[:, None] * 0.4
               + np.arange(c_in)[None]) + 0.1 * rs.randn(n + L + H, c_in)
    s = s.astype(np.float32)
    x, y = roll_windows(s, s[:, :c_out], L, H)
    return x[:n], y[:n]


@pytest.mark.parametrize("name", list(FORECASTERS))
def test_forward_with_carried_weights(name):
    j, t = _pair(name)
    x, _ = _data(name, 9)
    np.testing.assert_allclose(t.predict(x), j.predict(x), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("name", list(FORECASTERS))
def test_fit_two_epochs_equal_jax(name):
    j, t = _pair(name)
    x, y = _data(name)
    jl = j.fit((x, y), epochs=2, batch_size=16)
    tl = t.fit((x, y), epochs=2, batch_size=16)
    assert len(t.history) == 2 * (len(x) // 16)
    assert abs(tl - jl) <= 1e-4 * max(1.0, abs(jl))
    jw = dict(_items(_np(j.model.parameters_dict())))
    tw = dict(_items(t.model.get_weights()))
    assert jw.keys() == tw.keys()
    free = ZERO_GRAD.get(name, ())
    top = max(float(np.abs(v).max()) for v in jw.values())
    err = max(float(np.abs(tw[k] - jw[k]).max()) for k in jw
              if k not in free)
    assert err <= 1e-4 * top, (err, top)
    steps = len(t.history)
    for k in free:      # Adam moves a parameter at most ~lr a step
        assert float(np.abs(tw[k] - jw[k]).max()) <= steps * t.lr
    np.testing.assert_allclose(t.evaluate((x, y), ["mse", "smape"]),
                               j.evaluate((x, y), ["mse", "smape"]),
                               rtol=1e-3)


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), np.asarray(tree)


def test_zero_gradient_biases():
    _, t = _pair("autoformer")
    x, y = _data("autoformer", 16)
    loss = t.criterion.apply_loss(t.model(torch.tensor(x)),
                                  torch.tensor(y))
    names, params = zip(*t.model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    top = max(float(g.abs().max()) for g in grads.values())
    for k in ZERO_GRAD["autoformer"]:
        assert float(grads[k].abs().max()) <= 1e-6 * top


@pytest.mark.parametrize("name", list(FORECASTERS))
def test_save_load_round_trip(name, tmp_path):
    _, t = _pair(name)
    x, _ = _data(name, 5)
    want = t.predict(x)
    t.save(str(tmp_path / "m"))
    cls, kw = FORECASTERS[name]
    g = getattr(TF, cls)(**{**kw, "seed": 7}, device=CPU)
    g.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(g.predict(x), want)


@pytest.mark.parametrize("name", ["tcn", "lstm"])
def test_dropout_by_contract(name):
    p = 0.3
    x, y = _data(name)
    runs = []
    for seed in (0, 0, 1):
        cls, kw = FORECASTERS[name]
        f = getattr(TF, cls)(**{**kw, "dropout": p, "seed": seed},
                             device=CPU)
        f.fit((x, y), epochs=1, batch_size=16)
        runs.append(f.model.get_weights())
    same = [np.array_equal(a, b) for a, b in zip(
        *(dict(_items(r)).values() for r in runs[:2]))]
    assert all(same)
    assert not all(np.array_equal(a, b) for a, b in zip(
        *(dict(_items(r)).values() for r in runs[::2])))
    drop = next(m for m in f.model.modules()
                if type(m).__name__ == "Dropout").train()
    kept = float((drop(torch.ones(400, 500)) != 0).float().mean())
    jd = jnn.Dropout(p)
    jy, _ = jd.apply({}, {}, jnp.ones((400, 500)), training=True,
                     rng=jax.random.PRNGKey(0))
    for rate in (kept, float((np.asarray(jy) != 0).mean())):
        assert abs(rate - (1 - p)) <= 0.01, rate


# ---------------------------------------------------------------------------
# Autoformer's blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,kernel", [(24, 7), (96, 25), (50, 4)])
def test_series_decomp_equal_jax(length, kernel):
    x = np.random.RandomState(length).randn(3, length, 4).astype(np.float32)
    js, jt = j_decomp(jnp.asarray(x), kernel)
    ts, tt = _series_decomp(torch.from_numpy(x), kernel)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


FFT_TOL = 1e-4


@pytest.mark.parametrize("b,length,d,k,seed",
                         [(2, 24, 8, 3, 0), (4, 96, 16, 3, 1),
                          (3, 48, 8, 5, 2)])
def test_auto_correlation_equal_jax(b, length, d, k, seed):
    rs = np.random.RandomState(seed)
    q, kk, v = (rs.randn(b, length, d).astype(np.float32)
                for _ in range(3))
    # the delays JAX chooses: its own rfft / irfft / top_k
    corr = jnp.fft.irfft(jnp.fft.rfft(q, axis=1)
                         * jnp.conj(jnp.fft.rfft(kk, axis=1)),
                         n=length, axis=1).mean(axis=-1)
    jw, jtau = jax.lax.top_k(corr, k + 1)
    # top-k of scores within the FFT's error of each other is
    # ill-conditioned (either order is right), so each case must have
    # its k-th and (k+1)-th scores further apart than that error
    gap = np.asarray(jw[:, k - 1] - jw[:, k])
    assert (gap > FFT_TOL).all(), gap
    tw, ttau = _delays(*(torch.from_numpy(a) for a in (q, kk)), k)
    np.testing.assert_array_equal(ttau.numpy(), np.asarray(jtau[:, :k]))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw[:, :k]),
                               atol=FFT_TOL)
    want = j_auto_correlation(*(jnp.asarray(a) for a in (q, kk, v)), k)
    got = _auto_correlation(*(torch.from_numpy(a) for a in (q, kk, v)), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# Detectors
# ---------------------------------------------------------------------------

def _spiky(n=300, seed=1):
    rs = np.random.RandomState(seed)
    y = np.sin(np.arange(n) * 0.2) + rs.randn(n) * 0.02
    y[150:153] += 2.5
    return y


def test_ae_detector_equal_jax():
    y = _spiky()
    kw = dict(roll_len=16, ratio=0.05, hidden=8, epochs=40, seed=3)
    jd = JAEDetector(**kw).fit(y)
    jset_seed(kw["seed"])   # the JAX detector's initial weights
    init = (jnn.Sequential().add(jnn.Linear(16, 8)).add(jnn.Tanh())
            .add(jnn.Linear(8, 16)))
    td = AEDetector(**kw, device=CPU).fit(y, init_params=_np(
        init.parameters_dict()))
    assert abs(td._th - jd._th) <= 1e-5
    np.testing.assert_array_equal(td.anomaly_indexes(y),
                                  jd.anomaly_indexes(y))
    np.testing.assert_allclose(td.score(y), jd.score(y), atol=1e-5)


@pytest.mark.parametrize("pred", [True, False])
def test_threshold_and_dbscan_equal_jax(pred):
    y = _spiky(seed=2)
    y_pred = np.sin(np.arange(len(y)) * 0.2) if pred else None
    j = JThreshold().set_params(ratio=0.02).fit(y, y_pred)
    t = ThresholdDetector().set_params(ratio=0.02).fit(y, y_pred)
    assert t.th == j.th
    np.testing.assert_array_equal(t.anomaly_indexes(y, y_pred),
                                  j.anomaly_indexes(y, y_pred))
    np.testing.assert_array_equal(
        DBScanDetector(eps=0.3, min_samples=4).anomaly_indexes(y),
        JDBScanDetector(eps=0.3, min_samples=4).anomaly_indexes(y))


# ---------------------------------------------------------------------------
# DPGAN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp", [False, True], ids=["dp_off", "dp_on"])
def test_dpgan_step_equal_jax(dp):
    rs = np.random.RandomState(0)
    data = (np.sin(np.arange(24)[None, :, None] / 3 + rs.rand(40, 1, 1) * 6)
            * 2).astype(np.float32)
    kw = dict(seq_len=24, feature_num=1, noise_dim=8, hidden=16, lr=1e-2,
              dp=dp, seed=0)
    j = JDPGAN(**kw)
    t = DPGANSimulator(**kw, device=CPU).load_params(_np(j.g_params),
                                                     _np(j.d_params))
    key = j._key
    j.fit(data, epochs=1, batch_size=16)
    # the JAX step's draws, split as its jitted step splits them
    _, kz1, kz2, kn = jax.random.split(key, 4)
    z = jax.random.normal(kz1, (16, 8))
    z2 = jax.random.normal(kz2, (16, 8))
    noise = []
    for leaf in jax.tree_util.tree_leaves(t.d_params):
        kn, sub = jax.random.split(kn)
        noise.append(torch.from_numpy(np.asarray(
            jax.random.normal(sub, tuple(leaf.shape)))))
    xn = (data - data.mean()) / (2.5 * (data.std() + 1e-8))
    xr = xn[np.random.RandomState(0).permutation(len(xn))[:16]]
    dl, gl = t.train_step(torch.from_numpy(xr), *(
        torch.from_numpy(np.asarray(a)) for a in (z, z2)),
        noise if dp else None)
    assert abs(float(dl) - j.history[0][0]) <= 1e-5
    assert abs(float(gl) - j.history[0][1]) <= 1e-5
    for a, b in ((t.g_params, j.g_params), (t.d_params, j.d_params)):
        for x, w in zip(jax.tree_util.tree_leaves(_np(b)),
                        jax.tree_util.tree_leaves(a)):
            np.testing.assert_allclose(w.numpy(), x, atol=1e-5, rtol=0)


def test_dpgan_fit_generate_by_contract():
    data = (np.sin(np.arange(16))[None].repeat(32, 0)[..., None] * 2
            ).astype(np.float32)
    sim = DPGANSimulator(seq_len=16, dp=True, seed=0, device=CPU)
    sim.fit(data, epochs=3, batch_size=8)
    assert len(sim.history) == 3 and np.isfinite(sim.history).all()
    out = sim.generate(6, seed=1)
    assert out.shape == (6, 16, 1) and np.isfinite(out).all()
    assert np.abs(out).max() <= 2.5 * 2 * sim._std + abs(sim._mean) + 1e-3
    np.testing.assert_array_equal(out, sim.generate(6, seed=1))


# ---------------------------------------------------------------------------
# AutoTS
# ---------------------------------------------------------------------------

def test_autots_equal_jax(monkeypatch):
    """Each step repeats the value 10 steps back, plus noise: a lookback
    of 12 sees it, one of 4 cannot."""
    rs = np.random.RandomState(5)
    pattern = rs.randn(10)
    v = np.tile(pattern, 16) + 0.05 * rs.randn(160)
    df = pd.DataFrame({"dt": pd.date_range("2025-01-01", periods=160,
                                           freq="h"), "value": v})
    got = {}
    for name, mod, cls, space, dev in (
            ("jax", jauto_ts, JTSDataset, jhp, {}),
            ("port", tauto_ts, TSDataset, hp, {"device": CPU})):
        built = got.setdefault(name, [])
        real = mod._builders()["tcn"]

        def record(real=real, built=built, **kw):
            built.append({k: kw[k] for k in sorted(kw) if k != "device"})
            return real(**kw)

        monkeypatch.setitem(mod._MODEL_BUILDERS, "tcn", record)
        auto = mod.AutoTSEstimator(
            model="tcn", past_seq_len=space.choice([4, 12]),
            search_space={"num_channels": space.choice([(4,), (6,)]),
                          "lr": space.choice([1e-2, 2e-2]),
                          "dropout": 0.0}, **dev)
        pipe = auto.fit(cls.from_pandas(df, "dt", "value"), n_sampling=3,
                        epochs=4, batch_size=16, seed=1)
        built.append(pipe.lookback)
    assert got["port"] == got["jax"]
    # seed 1 draws both lookbacks, and the long one wins
    assert {b["past_seq_len"] for b in got["port"][:-1]} == {4, 12}
    assert got["port"][-1] == 12

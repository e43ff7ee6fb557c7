"""The port's ``orca.automl`` (``bigdl_tpu_torch.orca.automl``) held to the
JAX package's on the CPU.

- ``hp``: every sampler gives the JAX configs on one seed.
- ``AutoEstimator`` with a module-level numpy ridge regression (its
  scores are exact): serially, under ASHA and in ``mode="max"``, the
  trials (configs, order, scores), the best config and score, and ASHA's
  epochs spent equal the JAX estimator's. Over a two-worker
  ``RayContext`` the trials equal the serial run's. A lambda builder
  raises ``TaskNotPicklable`` in the parent before a task is sent.

The JAX package is imported inside the tests: the pool's spawned workers
import this module to unpickle ``Ridge``, and need nothing else.
"""

import numpy as np
import pytest

from bigdl_tpu_torch.orca import RayContext
from bigdl_tpu_torch.orca.automl import AutoEstimator, hp
from bigdl_tpu_torch.orca.automl.hp import sample_config
from bigdl_tpu_torch.orca.ray_pool import TaskNotPicklable


class Ridge:
    """A closed-form ridge regression under the builder contract; each
    ``fit`` call counts its epochs, and the score adds ``1 / (1 +
    epochs)`` so that ASHA's rungs see it improve."""

    spent = []

    def __init__(self, config):
        self.lam = config["lam"]
        self.shift = config.get("shift", 0.0)
        self.epochs = 0
        self.w = None

    def fit(self, data, epochs=1, batch_size=32):
        x, y = data
        self.epochs += epochs
        Ridge.spent.append(epochs)
        a = x.T @ x + self.lam * np.eye(x.shape[1])
        self.w = np.linalg.solve(a, x.T @ (y + self.shift))

    def evaluate(self, data, metrics=("mse",)):
        x, y = data
        return [float(np.mean((x @ self.w - y) ** 2))
                + 1.0 / (1 + self.epochs)]


def _data(n=96, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 4)
    y = x @ np.array([[1.0], [-2.0], [0.5], [3.0]]) + 0.1 * rs.randn(n, 1)
    return x, y


def _jax_automl():
    from bigdl_tpu.orca.automl import AutoEstimator as JAutoEstimator
    from bigdl_tpu.orca.automl import hp as jhp
    from bigdl_tpu.orca.automl.hp import sample_config as jsample
    return JAutoEstimator, jhp, jsample


def _space(h, grid):
    lam = h.grid_search([10.0, 1.0, 1e-3]) if grid else \
        h.loguniform(1e-3, 10.0)
    return {"lam": lam, "shift": h.uniform(-0.3, 0.3), "k": 3}


SAMPLERS = {
    "choice": lambda h: h.choice([1, "a", 2.5, (3, 4)]),
    "uniform": lambda h: h.uniform(-2.0, 5.0),
    "loguniform": lambda h: h.loguniform(1e-4, 1e-1),
    "randint": lambda h: h.randint(3, 40),
    "constant": lambda h: 7,
}


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_samplers_equal_jax(name):
    import random
    _, jhp, jsample = _jax_automl()
    space = {"a": SAMPLERS[name](hp), "b": SAMPLERS[name](hp)}
    jspace = {"a": SAMPLERS[name](jhp), "b": SAMPLERS[name](jhp)}
    r, jr = random.Random(4), random.Random(4)
    assert [sample_config(space, r) for _ in range(6)] == \
        [jsample(jspace, jr) for _ in range(6)]


RUNS = {
    "serial_grid": dict(grid=True),
    "serial_sampled": dict(grid=False, n_sampling=5),
    "serial_max": dict(grid=True, mode="max"),
    "asha": dict(grid=False, n_sampling=6, scheduler="asha", epochs=8,
                 grace_epochs=1, reduction_factor=2),
    "asha_grid": dict(grid=True, scheduler="asha", epochs=4,
                      grace_epochs=1, reduction_factor=3),
}


def _run(est_cls, h, run, **extra):
    kw = dict(RUNS[run])
    grid, mode = kw.pop("grid"), kw.pop("mode", "min")
    Ridge.spent = []
    est = est_cls(Ridge, metric="mse", mode=mode)
    x, y = _data()
    est.fit((x, y), validation_data=_data(48, 1),
            search_space=_space(h, grid), seed=3, **{**kw, **extra})
    return est, list(Ridge.spent)


@pytest.mark.parametrize("run", list(RUNS))
def test_auto_estimator_equal_jax(run):
    JAutoEstimator, jhp, _ = _jax_automl()
    est, spent = _run(AutoEstimator, hp, run)
    jest, jspent = _run(JAutoEstimator, jhp, run)
    assert est.trials == jest.trials          # configs, order, scores
    assert est.best_config == jest.best_config
    assert est.best_score == jest.best_score
    assert spent == jspent
    assert est.get_best_model().epochs == jest.get_best_model().epochs
    if run.startswith("asha"):
        n = len(est.trials)
        assert len({str(t["config"]) for t in est.trials}) == n
        assert sum(spent) < n * RUNS[run]["epochs"]


@pytest.fixture(scope="module")
def pool():
    with RayContext(num_workers=2) as ctx:
        yield ctx


@pytest.mark.parametrize("run", ["serial_grid", "serial_sampled"])
def test_pool_trials_equal_serial(run, pool):
    serial, _ = _run(AutoEstimator, hp, run)
    par, spent = _run(AutoEstimator, hp, run, ray_ctx=pool)
    assert par.trials == serial.trials
    assert par.best_config == serial.best_config
    # the winner is retrained in the parent for get_best_model()
    assert spent == [RUNS[run].get("epochs", 3)]
    assert par.get_best_model().evaluate(_data(48, 1)) == \
        serial.get_best_model().evaluate(_data(48, 1))


def test_lambda_builder_refused_in_parent(pool):
    est = AutoEstimator(lambda cfg: Ridge(cfg))
    with pytest.raises(TaskNotPicklable, match="module level"):
        est.fit(_data(), search_space={"lam": hp.grid_search([1.0])},
                ray_ctx=pool)
    assert est.trials == [] and not pool._refs

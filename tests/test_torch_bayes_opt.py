"""tools/bayes_opt.py against the JAX package's. The search is numpy on
both sides, so set_config_path, the GP's mean and variance, the EI, and
every suggestion of a seeded search fed the same objective values must be
equal to JAX's to the bit.

cli_objective runs the port's ``cli.train_with_result`` on the CPU on the
tiny config of JAX's own test (tests/test_bayes_opt.py:61-82). The port's
``cli.build_from_config`` is patched to start from JAX's initial state
(``bridge.train_state_from_jax``); the pore batches are JAX's to the bit
(tests/test_torch_cli.py). The trial's vloss (the best validation loss at
the prints of steps 3 and 6, after 6 Adam steps) is held to JAX's
cli_objective value within rtol 1e-4: the first step's metrics agree
within rtol 1e-4, atol 1e-6 (test_torch_cli.py's tolerance), and Adam's
normalised updates at lr 2e-3 carry that gap through 6 steps without
growing it past the same relative size."""
import copy

import numpy as np
import pytest
import torch

from wavenet_speech_tpu import cli as jcli
from wavenet_speech_tpu.tools import bayes_opt as jbo
from torch_threads import one_thread  # noqa: F401  (a fixture)
from wavenet_speech_tpu_torch import bridge, cli
from wavenet_speech_tpu_torch.tools import bayes_opt as bo

pytestmark = pytest.mark.usefixtures("one_thread")

VLOSS_RTOL = 1e-4

SPACE = {"training.optim.learning_rate": (1e-5, 1e-2, "log"),
         "training.optim.max_grad_norm": (0.5, 50.0, "log")}


def test_set_config_path_matches_jax():
    cfg = {"training": {"optim": {"learning_rate": 1e-3}}}
    for path, value in (("training.optim.learning_rate", 5e-4), ("training.new.flag", 1),
                        ("top", [1, 2])):
        got = bo.set_config_path(cfg, path, value)
        assert got == jbo.set_config_path(cfg, path, value)
    assert cfg == {"training": {"optim": {"learning_rate": 1e-3}}}   # deep copy


def test_gp_and_expected_improvement_equal_jax(rng):
    X, y = rng.random((7, 2)), rng.normal(size=7)
    Xs = rng.random((40, 2))
    gp, jgp = bo._GP(lengthscale=0.3, noise=1e-5), jbo._GP(lengthscale=0.3, noise=1e-5)
    gp.fit(X, y)
    jgp.fit(X, y)
    (m, s), (jm, js) = gp.predict(Xs), jgp.predict(Xs)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(bo.expected_improvement(m, s, y.min()),
                                  jbo.expected_improvement(jm, js, y.min()))
    # interpolation and the unexplored point's larger EI, as JAX's test
    m0, s0 = gp.predict(X)
    np.testing.assert_allclose(m0, y, atol=1e-3)
    assert s.max() > s0.max()


def _quadratic(values):
    lr = values["training.optim.learning_rate"]
    clip = values["training.optim.max_grad_norm"]
    return (np.log10(lr) + 3.0) ** 2 + 0.1 * (np.log10(clip) - 1.0) ** 2


def test_minimize_matches_jax_trial_for_trial():
    got = bo.BayesOpt(SPACE, seed=0).minimize(_quadratic, num_trials=8)
    want = jbo.BayesOpt(SPACE, seed=0).minimize(_quadratic, num_trials=8)
    assert got["trials"] == want["trials"]
    assert got["values"] == want["values"] and got["value"] == want["value"]
    assert got["value"] < 0.5


def test_integer_dimension_and_external_observations_match_jax():
    space = {"training.batch_size": (2, 16), "training.optim.learning_rate": (0.0, 1.0)}
    s, js = bo.BayesOpt(space, seed=1), jbo.BayesOpt(space, seed=1)
    v, jv = s.suggest(), js.suggest()
    assert v == jv and isinstance(v["training.batch_size"], int)
    assert 2 <= v["training.batch_size"] <= 16
    for opt in (s, js):
        opt.observe({"training.batch_size": 8, "training.optim.learning_rate": 0.25}, 0.5)
        opt.observe(v, 0.4)
        opt.observe({"training.batch_size": 30, "training.optim.learning_rate": -1.0}, 0.9)
    np.testing.assert_array_equal(np.asarray(s.X), np.asarray(js.X))
    assert s.y == js.y == [0.5, 0.4, 0.9]
    np.testing.assert_array_equal(s.X[2], [1.0, 0.0])    # clipped into the cube
    assert s.suggest() == js.suggest()


# JAX's test's config (tests/test_bayes_opt.py:61-82) with a seed: without
# one the pore stream draws fresh entropy, and the two runs would see other data
TINY_CFG = {
    "model": {"type": "wavenet-ctc",
              "base": {"signal_dim": 16, "entry_kwidth": 2, "kernel": 2,
                       "dilations": [1, 2]},
              "classifier": {"num_labels": 5, "kernel": 2,
                             "dilations": [1, 2], "downsample": 1,
                             "out_dim": 16}},
    "training": {"datatype": "pore", "batch_size": 2, "num_epochs": 1,
                 "max_iters": 6, "epoch_size": 6,
                 "min_sample_length": 8, "max_sample_length": 10,
                 "num_levels": 16,
                 "print_every": 3, "save_every": 100, "seed": 0,
                 "optim": {"type": "adam", "learning_rate": 1e-3}},
}


def test_cli_objective_matches_jax_from_jax_init(monkeypatch):
    values = {"training.optim.learning_rate": 2e-3}
    want = jbo.cli_objective(copy.deepcopy(TINY_CFG), platform=None)(values)
    real = cli.build_from_config

    def from_jax_init(cfg, device=None):
        ds, model, _, steps, eval_fn, t = real(cfg, device)
        jds, _, jstate, *_ = jcli.build_from_config(copy.deepcopy(cfg))
        jds.close()
        return ds, model, bridge.train_state_from_jax(jstate), steps, eval_fn, t

    monkeypatch.setattr(cli, "build_from_config", from_jax_init)
    got = bo.cli_objective(copy.deepcopy(TINY_CFG), device="cpu")(values)
    assert np.isfinite(got) and np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=VLOSS_RTOL)


def test_cli_objective_defaults_to_the_card(monkeypatch):
    """device=None is cuda, as every entry point of the port: without a card
    the trial raises before it trains."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bo.cli_objective(copy.deepcopy(TINY_CFG))({"training.optim.learning_rate": 2e-3})

"""Bayesian hyperparameter optimization over the CLI config schema
(wavenet_speech_tpu/tools/bayes_opt.py).

The reference shipped only a placeholder for this capability
(legacy_code/bayes_opt.py:8-17: "relies on gaussian process regression to
choose continuous hyperparameters" — class body `pass`). This is the
working version: a dependency-free Gaussian-process (RBF kernel) surrogate
with expected-improvement acquisition, searching continuous (optionally
log-scale) hyperparameters addressed by dotted config paths, with the
port's CLI training loop as the default objective. The search is numpy, as
in JAX: one seed gives the JAX tool's suggestions for the same objective
values.

Usage (offline tool):

    from wavenet_speech_tpu_torch.tools.bayes_opt import BayesOpt, cli_objective

    bo = BayesOpt({
        "training.optim.learning_rate": (1e-5, 1e-2, "log"),
        "training.optim.max_grad_norm": (0.5, 50.0, "log"),
    }, seed=0)
    best = bo.minimize(cli_objective(base_config, metric="vloss"),
                       num_trials=20, num_init=5)

Each trial trains on ``cuda``, on the port's kernels, unless
``cli_objective``'s ``device`` names another device (``device="cpu"`` runs
their plain versions).

Discrete choices (e.g. optimizer type) are, as the reference docstring
prescribes, tried as separate configurations: run one BayesOpt per choice
and compare `best["value"]`.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np


def set_config_path(cfg: Dict[str, Any], path: str, value) -> Dict[str, Any]:
    """Return a deep copy of cfg with the dotted `path` set to `value`."""
    out = copy.deepcopy(cfg)
    node = out
    keys = path.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value
    return out


class _GP:
    """Minimal exact-GP regression: RBF kernel + noise, unit-cube inputs."""

    def __init__(self, lengthscale: float = 0.25, noise: float = 1e-4):
        self.ls = lengthscale
        self.noise = noise
        self.X: Optional[np.ndarray] = None

    def _k(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.ls ** 2)

    def fit(self, X: np.ndarray, y: np.ndarray):
        self.X = X
        self.mu = float(y.mean())
        self.sd = float(y.std()) or 1.0
        yn = (y - self.mu) / self.sd
        K = self._k(X, X) + self.noise * np.eye(len(X))
        self.L = np.linalg.cholesky(K)
        self.alpha = np.linalg.solve(self.L.T, np.linalg.solve(self.L, yn))

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        Ks = self._k(Xs, self.X)
        mean = Ks @ self.alpha
        v = np.linalg.solve(self.L, Ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return mean * self.sd + self.mu, np.sqrt(var) * self.sd


def _norm_cdf(z):
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z):
    return np.exp(-0.5 * z ** 2) / math.sqrt(2.0 * math.pi)


def expected_improvement(mean, std, best):
    """EI for MINIMIZATION."""
    z = (best - mean) / std
    return (best - mean) * _norm_cdf(z) + std * _norm_pdf(z)


class BayesOpt:
    """GP-EI search over a box of continuous hyperparameters.

    space: {config_path: (low, high[, "log"])}. Integers are produced when
    both bounds are ints and scale is linear.
    """

    def __init__(self, space: Dict[str, Sequence], seed: int = 0,
                 lengthscale: float = 0.25):
        self.paths = list(space)
        self.bounds = []
        self.logs = []
        self.ints = []
        for p in self.paths:
            spec = space[p]
            lo, hi = spec[0], spec[1]
            log = len(spec) > 2 and spec[2] == "log"
            self.bounds.append((float(lo), float(hi)))
            self.logs.append(log)
            self.ints.append(not log and isinstance(lo, int)
                             and isinstance(hi, int))
        self.rng = np.random.default_rng(seed)
        self.gp = _GP(lengthscale=lengthscale)
        self.X: list = []  # unit-cube points
        self.y: list = []

    # --- unit cube <-> config values ---
    def _decode(self, u: np.ndarray) -> Dict[str, Any]:
        vals = {}
        for i, p in enumerate(self.paths):
            lo, hi = self.bounds[i]
            if self.logs[i]:
                v = math.exp(math.log(lo) + u[i] * (math.log(hi) - math.log(lo)))
            else:
                v = lo + u[i] * (hi - lo)
                if self.ints[i]:
                    v = int(round(v))
            vals[p] = v
        return vals

    def suggest(self, num_candidates: int = 512) -> Dict[str, Any]:
        """Next hyperparameters: random until 2 observations exist, then
        max-EI over a random candidate set (plus jittered incumbents)."""
        d = len(self.paths)
        if len(self.y) < 2:
            u = self.rng.random(d)
        else:
            self.gp.fit(np.asarray(self.X), np.asarray(self.y))
            cand = self.rng.random((num_candidates, d))
            inc = np.asarray(self.X)[np.argsort(self.y)[:4]]
            jit = np.clip(
                inc[None] + 0.05 * self.rng.standard_normal((8,) + inc.shape),
                0, 1).reshape(-1, d)
            cand = np.concatenate([cand, jit], axis=0)
            mean, std = self.gp.predict(cand)
            ei = expected_improvement(mean, std, min(self.y))
            u = cand[int(np.argmax(ei))]
        self._pending = u
        return self._decode(u)

    def observe(self, values: Dict[str, Any], objective_value: float):
        """Record a finished trial (values from `suggest`, or external)."""
        u = getattr(self, "_pending", None)
        if u is None or self._decode(u) != values:
            # encode external values into the unit cube
            u = np.zeros(len(self.paths))
            for i, p in enumerate(self.paths):
                lo, hi = self.bounds[i]
                v = float(values[p])
                if self.logs[i]:
                    u[i] = (math.log(v) - math.log(lo)) / (
                        math.log(hi) - math.log(lo))
                else:
                    u[i] = (v - lo) / (hi - lo)
            u = np.clip(u, 0, 1)
        self.X.append(np.asarray(u, float))
        self.y.append(float(objective_value))
        self._pending = None

    def minimize(self, objective: Callable[[Dict[str, Any]], float],
                 num_trials: int = 20, num_init: int = 0,
                 callback: Optional[Callable] = None) -> Dict[str, Any]:
        """Run the suggest/observe loop; returns
        {"values", "value", "trials"} for the best trial."""
        del num_init  # first two suggests are random by construction
        trials = []
        for t in range(num_trials):
            values = self.suggest()
            y = float(objective(values))
            self.observe(values, y)
            trials.append((values, y))
            if callback:
                callback(t, values, y)
        i = int(np.argmin([y for _, y in trials]))
        return {"values": trials[i][0], "value": trials[i][1],
                "trials": trials}


def cli_objective(base_config: Dict[str, Any], metric: str = "vloss",
                  device: Optional[str] = None):
    """Objective factory: apply suggested values to `base_config`, run the
    port's CLI training loop (``cli.train_with_result``) on ``device``
    (``cuda`` unless given) in a temporary save_dir, return the result's
    `metric` (the statistic the reference's BayesOpt docstring prescribes:
    'runs model against those configs for some number of fixed
    timesteps')."""

    def objective(values: Dict[str, Any]) -> float:
        import tempfile

        from wavenet_speech_tpu_torch import cli

        cfg = base_config
        for path, v in values.items():
            cfg = set_config_path(cfg, path, v)
        with tempfile.TemporaryDirectory() as td:
            cfg = set_config_path(cfg, "training.save_dir", td)
            result = cli.train_with_result(cfg, device)
        return float(result[metric])

    return objective

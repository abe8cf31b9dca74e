"""The port's train entry point and what it stands on (utils/config.py,
utils/run_logging.py, training/checkpoint.py, facade.Model.save/restore,
cli.py) on the CPU: the config readers against the JAX package's, torch
checkpoints (sync and async, resume, structure checks), ``train`` on
configs/overfit_pore.json in float32 and bf16 (logs, checkpoints, resume),
and the first step's metrics of ``build_from_config`` against the JAX
CLI's from the same state and batch (rtol 1e-4, atol 1e-6, as the step
tests; the params are not compared: Adam's first update is lr * sign(g),
so an element whose gradient is f32 rounding noise may move the other
way)."""
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from wavenet_speech_tpu import cli as jcli
from wavenet_speech_tpu.data.prefetch import batch_to_device as j_batch_to_device
from wavenet_speech_tpu.utils import config as jconfig
from wavenet_speech_tpu_torch import bridge, cli
from wavenet_speech_tpu_torch.data.prefetch import batch_to_device
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.training import TrainState, build_optimizer
from wavenet_speech_tpu_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                                          save_checkpoint,
                                                          wait_for_async_saves)
from wavenet_speech_tpu_torch.utils import config
from wavenet_speech_tpu_torch.utils.run_logging import Logger, MovingAverageMeter, Throughput
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_unflatten

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.json"))
TOL = dict(rtol=1e-4, atol=1e-6)
SMALL = {"model": {"base": {"signal_dim": 16, "dilations": [1, 2]},
                   "classifier": {"dilations": [1, 2], "downsample": 2}}}


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_config_round_trip_and_training_defaults_equal_jax(path, tmp_path):
    cfg = config.json_to_config(str(path))
    assert cfg == jconfig.json_to_config(str(path))
    config.config_to_json(cfg, str(tmp_path / "a.json"))
    jconfig.config_to_json(cfg, str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert config.json_to_config(str(tmp_path / "a.json")) == cfg
    assert config.training_cfg(cfg) == jconfig.training_cfg(cfg)
    assert config.training_cfg({}) == jconfig.training_cfg({})
    for fn in ("base_model_cfg", "classifier_cfg"):
        assert getattr(config, fn)(cfg) == getattr(jconfig, fn)(cfg)


def test_logger_and_meters(tmp_path):
    lg = Logger(str(tmp_path / "run"))
    lg.log("loss", 5, 1.25, 2.5)
    lg.message("hello")
    lg.metrics(5, train_loss=1.25)
    lg.close()
    assert (tmp_path / "run" / "ckpts").is_dir()
    assert (tmp_path / "run" / "logs" / "training.log").read_text() == \
        "loss @ step: 5 | Training: 1.2500 | Validation 2.5000 \n"
    assert json.loads((tmp_path / "run" / "logs" / "metrics.jsonl").read_text()) == \
        {"step": 5, "train_loss": 1.25}
    m = MovingAverageMeter(2)
    assert np.isnan(m.value)
    for v in (1.0, 2.0, 4.0):
        m.add(v)
    assert m.value == 3.0
    t = Throughput()
    t.tick(10)
    assert t.samples_per_sec is None
    t.tick(30)
    assert t.samples_per_sec > 0


# ---- checkpoints --------------------------------------------------------------------

def _state(optim="adam", seed=0):
    model = Model("wavenet-ctc", SMALL, device="cpu").init(seed)
    tx = build_optimizer(optim, 1e-3)
    state = TrainState.create(model.params(), tx)
    # a state that is not fresh: every leaf moved
    g = torch.Generator().manual_seed(seed)
    moved = [t + torch.rand(t.shape, generator=g) if t.is_floating_point() else t + 3
             for t in tree_leaves((state.params, state.opt_state))]
    params, opt_state = tree_unflatten((state.params, state.opt_state), moved)
    return TrainState(params, opt_state, torch.tensor(7, dtype=torch.int32))


def _assert_states_equal(a, b):
    for x, y in zip(tree_leaves((a.params, a.opt_state)), tree_leaves((b.params, b.opt_state))):
        assert torch.equal(x, y)
    assert int(a.step) == int(b.step)


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpoint_save_restore(tmp_path, async_save):
    ckpt = str(tmp_path / "ckpts")
    assert latest_step(ckpt) is None
    state = _state()
    assert save_checkpoint(ckpt, state, async_save=async_save) == 7
    later = TrainState(state.params, state.opt_state, torch.tensor(12, dtype=torch.int32))
    save_checkpoint(ckpt, later, async_save=async_save)
    wait_for_async_saves(ckpt)
    assert latest_step(ckpt) == 12
    assert sorted(os.listdir(ckpt)) == ["12", "7"]  # no temporary directory left
    like = _state(seed=1)
    _assert_states_equal(restore_checkpoint(ckpt, like, step=7), state)
    restored = restore_checkpoint(ckpt, like)
    _assert_states_equal(restored, later)
    assert restored.step.dtype == torch.int32
    # a step that exists is not written again
    save_checkpoint(ckpt, TrainState(like.params, like.opt_state, later.step))
    _assert_states_equal(restore_checkpoint(ckpt, like), later)


@pytest.mark.parametrize("case", ["optimizer", "shape", "empty"])
def test_checkpoint_restore_checks_structure(tmp_path, case):
    ckpt = str(tmp_path / "ckpts")
    if case == "empty":
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(ckpt, _state())
        return
    save_checkpoint(ckpt, _state())
    like = _state("adagrad" if case == "optimizer" else "adam")
    if case == "shape":
        like.params["base"]["entry.b"] = torch.zeros(3)
    with pytest.raises(ValueError, match="checkpoint"):
        restore_checkpoint(ckpt, like)


def test_model_save_restore(tmp_path):
    a = Model("wavenet-ctc", SMALL, device="cpu").init(0)
    b = Model("wavenet-ctc", SMALL, device="cpu").init(1)
    a.save(str(tmp_path / "p.pt"))
    tree = b.restore(str(tmp_path / "p.pt"))
    for x, y, z in zip(tree_leaves(tree), tree_leaves(a.params()), tree_leaves(b.params())):
        assert torch.equal(x, y) and torch.equal(y, z)
    assert b.eval_base() is b.model_base
    shifted = {k: {n: t + 1 for n, t in v.items()} for k, v in a.params().items()}
    a.save(str(tmp_path / "q.pt"), shifted)
    got = a.restore(str(tmp_path / "q.pt"), a.params())
    assert torch.equal(got["ctc"]["out2.w"], shifted["ctc"]["out2.w"])


# ---- the train entry point ----------------------------------------------------------

def _overfit_cfg(tmp_path, **overrides):
    cfg = json.loads((ROOT / "configs" / "overfit_pore.json").read_text())
    cfg["training"].update(dict(save_dir=str(tmp_path / "run"), max_iters=10, print_every=5,
                                save_every=5), **overrides)
    return cfg


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_logs_checkpoints_and_resumes(tmp_path, dtype, capsys):
    extra = {"compute_dtype": "bf16", "async_checkpoint": True} if dtype == "bf16" else {}
    cfg = _overfit_cfg(tmp_path, **extra)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert cli.main(["train", str(path), "--device", "cpu"]) == 0
    run = tmp_path / "run"
    assert sorted(os.listdir(run / "ckpts")) == ["10", "5"]
    assert json.loads((run / "config.json").read_text()) == cfg
    lines = (run / "logs" / "training.log").read_text().splitlines()
    assert [l.split("|")[0] for l in lines] == ["loss @ step: 5 ", "loss @ step: 10 "]
    metrics = [json.loads(l) for l in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(m["train_loss"]) and np.isfinite(m["valid_loss"]) for m in metrics)
    # again on the same run directory: resumes at 10 and counts on to 20
    result = cli.train_with_result(cfg, "cpu")
    assert result["steps"] == 20 and np.isfinite(result["vloss"])
    assert sorted(os.listdir(run / "ckpts"), key=int) == ["5", "10", "15", "20"]
    messages = (run / "logs" / "messages.log").read_text()
    assert f"resumed from {run}/ckpts/ @ step 10" in messages
    assert "step 20:" in capsys.readouterr().out


def test_train_runs_as_module(tmp_path):
    cfg = _overfit_cfg(tmp_path, max_iters=4, print_every=2, save_every=4,
                       steps_per_call=2, xe_pretrain_iters=2)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "wavenet_speech_tpu_torch.cli", "train",
                          str(path), "--device", "cpu"], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 4:" in out.stdout
    assert latest_step(str(tmp_path / "run" / "ckpts")) == 4


def test_main_arms_the_stall_watchdog_only_when_asked(tmp_path, monkeypatch):
    started = []

    class Thread:
        def __init__(self, target, args, daemon):
            started.append((target, args, daemon))

        def start(self):
            pass

    monkeypatch.setattr(cli.threading, "Thread", Thread)
    monkeypatch.setattr(cli, "train", lambda cfg, device: 0)
    monkeypatch.setitem(cli._progress, "armed", False)
    monkeypatch.delenv("WAVENET_CLI_STALL_SECS", raising=False)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(_overfit_cfg(tmp_path)))
    assert cli.main(["train", str(path)]) == 0
    assert started == [] and not cli._progress["armed"]
    monkeypatch.setenv("WAVENET_CLI_STALL_SECS", "30")
    assert cli.main(["train", str(path), "--device", "cpu"]) == 0
    assert started == [(cli._stall_watchdog, (30.0,), True)] and cli._progress["armed"]


def test_stall_watchdog_reexecs_the_cli_module(monkeypatch):
    """A stalled loop re-runs ``python -m wavenet_speech_tpu_torch.cli`` with
    the same arguments (which resumes from the latest checkpoint, as
    test_train_logs_checkpoints_and_resumes shows); a loop that ticks is
    left alone."""
    calls = []

    class Reexec(Exception):
        pass

    def execv(path, args):
        calls.append((path, args))
        raise Reexec

    monkeypatch.setattr(cli.os, "execv", execv)
    monkeypatch.setattr(cli.sys, "argv", ["/elsewhere/cli.py", "train", "cfg.json",
                                          "--device", "cpu"])
    monkeypatch.setitem(cli._progress, "armed", True)
    monkeypatch.setitem(cli._progress, "t", time.time() - 60)
    with pytest.raises(Reexec):
        cli._stall_watchdog(30.0, poll_seconds=0)
    assert calls == [(sys.executable, [sys.executable, "-m", "wavenet_speech_tpu_torch.cli",
                                       "train", "cfg.json", "--device", "cpu"])]
    sleeps = []

    def sleep(secs):
        sleeps.append(secs)
        cli._tick()
        if len(sleeps) == 3:
            raise Reexec

    monkeypatch.setattr(cli.time, "sleep", sleep)
    with pytest.raises(Reexec):
        cli._stall_watchdog(30.0, poll_seconds=0)
    assert len(calls) == 1


@pytest.mark.parametrize("length_aware", [False, True])
def test_build_from_config_first_step_matches_jax(tmp_path, length_aware):
    cfg = _overfit_cfg(tmp_path, length_aware_ctc=length_aware)
    jds, _, jstate, (jstep, *_), _, _ = jcli.build_from_config(copy.deepcopy(cfg))
    ds, model, _, (step, *_), eval_fn, t = cli.build_from_config(copy.deepcopy(cfg), "cpu")
    state = bridge.train_state_from_jax(jstate)
    batch = ds.fetch("train")
    jbatch = jds.fetch("train")
    for f in ("signal", "labels", "label_lengths", "signal_lengths"):
        np.testing.assert_array_equal(getattr(batch, f), getattr(jbatch, f))
    jstate, jm = jstep(jstate, j_batch_to_device(jbatch))
    state, m = step(state, batch_to_device(batch, model.device))
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), err_msg=k, **TOL)
    ev = eval_fn(state.params, batch_to_device(ds.fetch("valid"), "cpu"))
    assert all(torch.isfinite(v) for v in ev.values())

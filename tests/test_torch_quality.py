"""The port's quality harness (wavenet_speech_tpu_torch/examples/
gaussian_eval.py) against the JAX package's (examples/gaussian_eval.py) on
the CPU, and the checkpoint rotation it uses.

Held: from JAX's initial params (bridged), ``--smoke --steps 3
--eval-batches 1`` gives JAX's result JSON: the same keys, the per-logit
CTC within CTC_RTOL (three Adamax steps of float32 sums in another order)
and equal identities. 4 straight steps equal 2 steps plus 2 resumed, to
the bit, and --eval-only prints the same JSON. --cosine and --warmup give
optax's schedules. save_checkpoint's max_to_keep keeps the newest step
directories, sync and async. A non-finite batch leaves one dump in JAX's
layout and no checkpoint of its window."""
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from examples import gaussian_eval as jax_harness
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.examples import gaussian_eval as harness
from wavenet_speech_tpu_torch.training import TrainState, build_optimizer
from wavenet_speech_tpu_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                                          save_checkpoint,
                                                          wait_for_async_saves)
from wavenet_speech_tpu_torch.utils.tree import tree_leaves

CTC_RTOL = 1e-4
SMOKE = ["--smoke", "--eval-batches", "1"]


def jax_init_params():
    jm = jax_harness.build_model(1 / 64, remat=False)
    return bridge.raw_ctcnet_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))


def test_smoke_result_matches_jax_harness(tmp_path):
    want = jax_harness.main([*SMOKE, "--steps", "3", "--platform", "cpu",
                             "--out", str(tmp_path / "jax.json")])
    got = harness.main([*SMOKE, "--steps", "3", "--device", "cpu",
                        "--out", str(tmp_path / "port.json")], params=jax_init_params())
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert set(got) == set(want) and got["reference_anchor"] == want["reference_anchor"]
    np.testing.assert_allclose(got["avg_per_logit_ctc"], want["avg_per_logit_ctc"],
                               rtol=CTC_RTOL)
    np.testing.assert_allclose(got["ref_convention_per_logit_ctc"],
                               want["ref_convention_per_logit_ctc"], rtol=CTC_RTOL)
    assert got["identities"] == want["identities"] and len(got["identities"]) == 4
    assert got["mean_identity"] == pytest.approx(want["mean_identity"], abs=1e-12)


def payload(ckpt_dir, step):
    return torch.load(os.path.join(ckpt_dir, str(step), "state.pt"), weights_only=True)


def test_resume_equals_a_straight_run_and_eval_only_reprints(tmp_path, capsys):
    run = [*SMOKE, "--device", "cpu", "--save-every", "2", "--no-remat"]
    a = harness.main([*run, "--steps", "4", "--ckpt-dir", str(tmp_path / "a")])
    harness.main([*run, "--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    b = harness.main([*run, "--steps", "4", "--ckpt-dir", str(tmp_path / "b")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert a == b
    pa, pb = payload(tmp_path / "a", 4), payload(tmp_path / "b", 4)
    assert pa["step"] == pb["step"] == 4
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(pa), tree_leaves(pb))
               if torch.is_tensor(x))
    assert sorted(os.listdir(tmp_path / "a")) == ["2", "4"]
    e = harness.main([*run, "--steps", "4", "--eval-only", "--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert e == a and "resumed from step 4" in out
    assert json.loads(out.strip().splitlines()[-1]) == a


@pytest.mark.parametrize("flags,want", [
    (["--cosine", "--steps", "1000"],
     optax.warmup_cosine_decay_schedule(0.0, 2e-4, warmup_steps=100, decay_steps=1000,
                                        end_value=1e-5)),
    (["--cosine", "--steps", "9"],
     optax.warmup_cosine_decay_schedule(0.0, 2e-4, warmup_steps=0, decay_steps=9,
                                        end_value=1e-5)),
    (["--warmup", "300"], optax.linear_schedule(0.0, 2e-4, 300)),
    ([], lambda count: 2e-4),
])
def test_schedules_match_optax(flags, want):
    lr = harness.learning_rate(harness.parse_args(flags))
    for count in (0, 1, 5, 50, 99, 100, 101, 299, 300, 301, 700, 999, 1000, 1500):
        got = lr(torch.tensor(count, dtype=torch.int32)) if callable(lr) else lr
        np.testing.assert_allclose(float(got), float(want(count)), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("async_save", [False, True])
def test_max_to_keep_keeps_the_newest_step_directories(tmp_path, async_save):
    tx = build_optimizer("adamax", 1e-3)
    params = {"w": torch.zeros(3)}
    for step in range(1, 7):
        state = TrainState.create({"w": torch.full((3,), float(step))}, tx)
        save_checkpoint(str(tmp_path), state, step=step, max_to_keep=3, async_save=async_save)
    wait_for_async_saves(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["4", "5", "6"]   # no hidden leftovers
    assert latest_step(str(tmp_path)) == 6
    restored = restore_checkpoint(str(tmp_path), TrainState.create(params, tx))
    assert torch.equal(restored.params["w"], torch.full((3,), 6.0))
    save_checkpoint(str(tmp_path), TrainState.create(params, tx), step=6, max_to_keep=1)
    assert sorted(os.listdir(tmp_path)) == ["4", "5", "6"]   # an existing step: no save
    save_checkpoint(str(tmp_path), TrainState.create(params, tx), step=7, max_to_keep=2)
    assert sorted(os.listdir(tmp_path)) == ["6", "7"]
    with pytest.raises(ValueError, match="max_to_keep"):
        save_checkpoint(str(tmp_path), TrainState.create(params, tx), step=8, max_to_keep=0)


def test_nonfinite_batch_dumps_once_and_skips_its_checkpoint(tmp_path, monkeypatch, capsys):
    """The second batch's signal holds a NaN: the step is skipped, one dump
    step_1_nonfinite is written beside the checkpoint directory, and the
    checkpoint at step 2 (its window) is not."""
    real = harness.RawGaussianModelLoader

    class Poisoned(real):
        fetches = 0

        def fetch(self):
            b = super().fetch()
            Poisoned.fetches += 1
            if Poisoned.fetches == 2:
                b.signal[0, 0, 0] = np.nan
            return b

    monkeypatch.setattr(harness, "RawGaussianModelLoader", Poisoned)
    ckpt = tmp_path / "run" / "ckpts"
    harness.main([*SMOKE, "--device", "cpu", "--steps", "4", "--save-every", "2",
                  "--ckpt-dir", str(ckpt)])
    err = capsys.readouterr().err
    assert "non-finite loss at step 1; update skipped (streak 1)" in err
    assert "skipping checkpoint at step 2" in err
    assert sorted(os.listdir(ckpt)) == ["4"]
    dumps = tmp_path / "run" / "anomalies"
    assert os.listdir(dumps) == ["step_1_nonfinite"]
    assert sorted(os.listdir(dumps / "step_1_nonfinite")) == ["batch.npz", "meta.json",
                                                              "params"]
    meta = json.loads((dumps / "step_1_nonfinite" / "meta.json").read_text())
    assert meta["step"] == 1 and meta["note"] == "nonfinite" and np.isnan(meta["ctc_loss"])
    with np.load(dumps / "step_1_nonfinite" / "batch.npz") as z:
        assert np.isnan(z["signal"][0, 0, 0])

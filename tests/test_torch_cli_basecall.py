"""The port's ``basecall`` command (cli.py) against the JAX CLI's on the
CPU, from checkpoints of the same weights: a JAX train state saved by the
JAX package, and the same state bridged (bridge.train_state_from_jax) and
saved by the port. Tiny wavenet-ctc and raw-ctcnet configs (the second is
configs/gauss_quality.json at narrow width and depth), signals made from a
seed, the untrained heads shaped away from near-ties as JAX's long-read
tests do.

Held: the short path's FASTA sequences equal the JAX CLI's and its scores
within 1e-3 (the beam tests' tolerance), for the three input forms. The
long path (``--long`` and the automatic switch) equals JAX's
``Basecaller.basecall_long_batch`` given a model that carries its
receptive field; the JAX CLI's own long path stitches with margin 0 and
is shown to differ from the monolithic forward at chunk boundaries."""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu import cli as jcli
from wavenet_speech_tpu import facade as jfacade
from wavenet_speech_tpu import inference as jinference
from wavenet_speech_tpu.training import TrainState as JTrainState
from wavenet_speech_tpu.training import build_optimizer as jbuild_optimizer
from wavenet_speech_tpu.training.checkpoint import save_checkpoint as jsave_checkpoint
from wavenet_speech_tpu.utils.config import training_cfg
from wavenet_speech_tpu_torch import bridge, cli, inference
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.inference import chunked_logits_batch
from wavenet_speech_tpu_torch.training.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parent.parent
SCORE_ATOL = 1e-3
TOL = dict(rtol=1e-4, atol=1e-5)
LONG = dict(chunk_len=256, beam_chunk_frames=128, label_window=256)  # the JAX test's sizes


def wavenet_ctc_cfg(pool=2):
    return {"model": {"type": "wavenet-ctc",
                      "base": {"signal_dim": 16, "dilations": [1, 2]},
                      "classifier": {"dilations": [1, 2], "downsample": pool}},
            "training": {"beam_width": 4, "seed": 3, "optim": {"type": "adam"}}}


def raw_ctcnet_cfg():
    cfg = json.loads((ROOT / "configs" / "gauss_quality.json").read_text())
    cfg["model"]["raw"].update(num_features=8, out_dim=8, num_dilation_blocks=1,
                               dilations=[1, 2])
    cfg["training"].update(beam_width=4)
    return cfg


def _write_runs(tmp, name, cfg, key):
    """Two configs of one model, each with a checkpoint of the same
    weights: the JAX CLI's (Orbax) and the port's (torch). Returns (JAX
    config path, port config path, the JAX facade Model, its params)."""
    jm = jfacade.Model(cfg["model"]["type"], cfg)
    params = jm.init(jax.random.PRNGKey(key))
    head = params["ctc"]["out2"]
    head["b"] = head["b"] + jnp.asarray([0.6, 0.9, -0.3, 0.1, -0.7])
    head["w"] = head["w"] * 3.0
    if "gamma" in params["base"]:
        params["base"] = dict(params["base"], mean=jnp.asarray([0.1]), var=jnp.asarray([1.5]))
    opt = training_cfg(cfg)["optim"]
    state = JTrainState.create(params, jbuild_optimizer(
        opt["type"], opt["learning_rate"], weight_decay=opt.get("wd") or None,
        max_grad_norm=opt.get("max_grad_norm")))
    paths = []
    for side in ("jax", "port"):
        run = tmp / f"{name}-{side}"
        c = json.loads(json.dumps(cfg))
        c["training"]["save_dir"] = str(run)
        if side == "jax":
            jsave_checkpoint(str(run / "ckpts"), state)
        else:
            save_checkpoint(str(run / "ckpts"), bridge.train_state_from_jax(state))
        path = tmp / f"{name}-{side}.json"
        path.write_text(json.dumps(c))
        paths.append(str(path))
    return paths[0], paths[1], jm, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("basecall")
    return {"wavenet-ctc": _write_runs(tmp, "wctc", wavenet_ctc_cfg(), 1),
            "raw-ctcnet": _write_runs(tmp, "raw", raw_ctcnet_cfg(), 2)}, tmp


def read_fasta(path):
    lines = Path(path).read_text().splitlines()
    assert [l.split()[0] for l in lines[::2]] == [f">read_{i}" for i in range(len(lines) // 2)]
    return lines[1::2], [float(l.split("score=")[1]) for l in lines[::2]]


def assert_fasta_equal(got, want):
    (s1, c1), (s0, c0) = read_fasta(got), read_fasta(want)
    assert s1 == s0 and all(s and set(s) <= set("ACGT") for s in s1)
    np.testing.assert_allclose(c1, c0, rtol=0, atol=SCORE_ATOL)


INPUTS = {"wavenet-ctc-levels": ("wavenet-ctc", lambda rng: rng.integers(0, 16, (3, 150))),
          "wavenet-ctc-floats": ("wavenet-ctc",
                                 lambda rng: rng.standard_normal((3, 150)).astype(np.float32)),
          "raw-ctcnet": ("raw-ctcnet",
                         lambda rng: rng.standard_normal((3, 150)).astype(np.float32))}


@pytest.mark.parametrize("form", INPUTS)
def test_short_basecall_matches_jax_cli(runs, form):
    """Integer levels (one-hot), raw floats into wavenet-ctc (mu-law, one-hot)
    and raw floats into raw-ctcnet ((B, L, 1)), through the monolithic
    Basecaller with each model's logit lengths."""
    (jcfg, cfg, _, _), tmp = runs[0][INPUTS[form][0]], runs[1]
    sig = tmp / f"{form}.npy"
    np.save(sig, INPUTS[form][1](np.random.default_rng(0)))
    assert jcli.main(["basecall", jcfg, "--signals", str(sig), "--out",
                      str(tmp / f"{form}-jax.fa")]) == 0
    assert cli.main(["basecall", cfg, "--signals", str(sig), "--out",
                     str(tmp / f"{form}.fa"), "--device", "cpu"]) == 0
    assert_fasta_equal(tmp / f"{form}.fa", tmp / f"{form}-jax.fa")


class WithReceptiveField:
    """A JAX model for the JAX Basecaller: the facade pair's forward, with
    the RawCTCNet's feature_kwidth, layers and output_length that the chunk
    grid reads (what the JAX CLI's wrapper, cli.py:413-416, leaves out)."""

    def __init__(self, jm):
        self.jm, r = jm, jm.model_ctc
        self.feature_kwidth, self.layers, self.output_length = (r.feature_kwidth, r.layers,
                                                                r.output_length)

    def apply(self, params, x):
        return self.jm.predict(params, x)[1]


class JaxCliPipe:
    """The JAX CLI's wrapper (cli.py:413-416): the forward alone."""

    def __init__(self, jm):
        self.jm = jm

    def apply(self, params, x):
        return self.jm.predict(params, x)[1]


def test_long_basecall_matches_jax_basecall_long_batch(runs, monkeypatch):
    """--long, and the automatic switch above the long-read threshold, on
    reads of 700 samples with the long path's sizes cut (chunks of 256
    samples, beam chunks of 128 frames): one batched call, whose FASTA
    equals JAX's basecall_long_batch given the model with its receptive
    field."""
    (_, cfg, jm, params), tmp = runs[0]["raw-ctcnet"], runs[1]
    sig = np.random.default_rng(1).standard_normal((3, 700)).astype(np.float32)
    np.save(tmp / "long.npy", sig)
    calls = []
    orig = inference.Basecaller.basecall_long_batch

    def cut(self, signals, **kw):
        calls.append(signals.shape)
        return orig(self, signals, **{**LONG, **kw})

    monkeypatch.setattr(inference.Basecaller, "basecall_long_batch", cut)
    assert cli.main(["basecall", cfg, "--signals", str(tmp / "long.npy"), "--out",
                     str(tmp / "long.fa"), "--long", "--device", "cpu"]) == 0
    monkeypatch.setattr(cli, "LONG_READ_SAMPLES", 699)
    assert cli.main(["basecall", cfg, "--signals", str(tmp / "long.npy"), "--out",
                     str(tmp / "auto.fa"), "--device", "cpu"]) == 0
    assert calls == [(3, 700, 1)] * 2
    seqs, scores = jinference.Basecaller(model=WithReceptiveField(jm), params=params,
                                         beam_width=4).basecall_long_batch(sig[..., None],
                                                                           **LONG)
    (tmp / "long-jax.fa").write_text("".join(
        f">read_{i} score={sc:.3f}\n{s}\n" for i, (s, sc) in enumerate(zip(seqs, scores))))
    assert_fasta_equal(tmp / "long.fa", tmp / "long-jax.fa")
    assert (tmp / "auto.fa").read_text() == (tmp / "long.fa").read_text()


def test_jax_cli_long_path_differs_at_chunk_boundaries(runs):
    """The gap the port does not copy: JAX's chunked logits through the JAX
    CLI's wrapper (margin 0, no featurizer extension) lose the last fk - 1
    frames and differ from the monolithic forward next to every interior
    chunk boundary; with the model's receptive field, and in the port,
    they equal it."""
    _, cfg, jm, params = runs[0]["raw-ctcnet"]
    sigs = np.random.default_rng(2).standard_normal((2, 700, 1)).astype(np.float32)
    full = np.asarray(jm.predict(params, jnp.asarray(sigs))[1])
    pipe = jinference.chunked_logits_batch(JaxCliPipe(jm), params, sigs, chunk_len=256)
    fixed = jinference.chunked_logits_batch(WithReceptiveField(jm), params, sigs,
                                            chunk_len=256)
    port = Model("raw-ctcnet", json.loads(Path(cfg).read_text()), device="cpu").load_jax(
        jax.tree_util.tree_map(np.asarray, params))
    got = chunked_logits_batch(port, sigs, chunk_len=256).numpy()
    assert full.shape == fixed.shape == got.shape == (2, 702, 5) and pipe.shape == (2, 700, 5)
    np.testing.assert_allclose(fixed, full, **TOL)
    np.testing.assert_allclose(got, full, **TOL)
    bad = np.abs(pipe - full[:, :700]).max(-1) > 1e-3
    frames = sorted(set(np.nonzero(bad)[1].tolist()))
    print(f"JAX CLI long path: {bad.sum()} of {2 * 702} frames differ from the monolithic "
          f"forward by more than 1e-3 (max {np.abs(pipe - full[:, :700]).max():.3f}), at "
          f"frames {frames}; the last 2 frames are missing")
    starts, bounds, _ = jinference._chunk_grid(JaxCliPipe(jm), 700, 256, 0)
    edges = [s + lo for s, (lo, _) in zip(starts[1:], bounds[1:])]  # interior boundaries
    assert bad.any() and all(min(abs(f - e) for e in edges) <= 8 for f in frames)


def test_long_basecall_refuses_pooled_wavenet_ctc(runs, monkeypatch):
    """A pooled wavenet-ctc head on reads longer than one chunk: ValueError
    before any forward (the JAX CLI fails an assertion after them)."""
    (_, cfg, _, _), tmp = runs[0]["wavenet-ctc"], runs[1]
    np.save(tmp / "pooled.npy", np.random.default_rng(3).integers(0, 16, (2, 700)))
    orig = inference.Basecaller.basecall_long_batch
    monkeypatch.setattr(inference.Basecaller, "basecall_long_batch",
                        functools.partialmethod(orig, **LONG))
    with pytest.raises(ValueError, match="pool"):
        cli.main(["basecall", cfg, "--signals", str(tmp / "pooled.npy"), "--long",
                  "--device", "cpu"])


def test_basecall_arguments_and_device(runs, tmp_path, capsys):
    (_, cfg, _, _), tmp = runs[0]["raw-ctcnet"], runs[1]
    np.save(tmp / "two.npy", np.random.default_rng(4).standard_normal((2, 90)))
    assert cli.main(["basecall", cfg, "--signals", str(tmp / "two.npy"), "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [l.split()[0] for l in out[::2]] == [">read_0", ">read_1"]
    with pytest.raises(SystemExit):
        cli.main(["basecall", cfg, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["basecall", cfg, "--signals", str(tmp / "two.npy")])
    # train on raw-ctcnet now runs (a copy of the config: the module's
    # checkpoints stay as they are)
    c = json.loads(Path(cfg).read_text())
    c["training"].update(save_dir=str(tmp_path / "train"), max_iters=2, print_every=1,
                         save_every=2)
    (tmp_path / "train.json").write_text(json.dumps(c))
    assert cli.main(["train", str(tmp_path / "train.json"), "--device", "cpu"]) == 0
    assert (tmp_path / "train" / "ckpts" / "2" / "state.pt").is_file()

"""The port's scoring path against the JAX package on the CPU:
decoding/alignment.py (Needleman-Wunsch, identity) and decoding/
prefix_beam.py on random inputs (exact: the same Python arithmetic),
facade.Decoder (argmax, beam on the python and device engines, the
emission times), and the ``evaluate`` command on a narrow copy of
configs/gauss_quality.json and on a small wavenet-ctc pair on pore data:
from checkpoints of the same weights (the JAX
CLI's Orbax one, and the port's carried over by
bridge.train_state_from_jax) both print the same line, the loss within
1e-4 relative (float32 sums in another order) and the identity equal. Also
the port's ``train`` on that config: it resumes, moves BatchNorm's running
statistics, and ``evaluate`` then scores the run."""
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu import cli as jcli
from wavenet_speech_tpu import facade as jfacade
from wavenet_speech_tpu.decoding import alignment as jalign
from wavenet_speech_tpu.decoding import prefix_beam as jpb
from wavenet_speech_tpu.training import TrainState as JTrainState
from wavenet_speech_tpu.training import build_optimizer as j_build_optimizer
from wavenet_speech_tpu.training.checkpoint import save_checkpoint as j_save_checkpoint
from wavenet_speech_tpu_torch import bridge, cli
from wavenet_speech_tpu_torch.decoding import alignment, prefix_beam
from wavenet_speech_tpu_torch.facade import Decoder
from wavenet_speech_tpu_torch.training.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
LINE = re.compile(r"eval loss over (\d+) batches: (\S+) \| basecall identity: (\S+)")
LOSS_RTOL = 1e-4


def _seqs(rng, n, lo, hi):
    return [list(rng.integers(1, 5, size=int(rng.integers(lo, hi)))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alignment_matches_jax(seed):
    rng = np.random.default_rng(seed)
    preds, truths = _seqs(rng, 6, 0, 30), _seqs(rng, 6, 1, 30)
    truths[0] = list(preds[1])  # one exact match
    for a, b in zip(preds, truths):
        assert alignment.needleman_wunsch(a, b) == jalign.needleman_wunsch(a, b)
        assert alignment.alignment_identity(a, b) == jalign.alignment_identity(a, b)
    got, want = alignment.batch_identity(preds, truths), jalign.batch_identity(preds, truths)
    assert got == want and 0.0 <= got[0] <= 1.0
    assert alignment.alignment_identity([], []) == (1.0, 0, 0)
    assert alignment.alignment_identity(truths[0], truths[0])[0] == 1.0


@pytest.mark.parametrize("log_input", [False, True])
def test_prefix_beam_matches_jax(log_input):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 14, 5))
    if log_input:
        logits = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lengths = np.array([14, 9, 1])
    got = prefix_beam.beam_search_decode(logits, 4, 0, lengths, log_input=log_input)
    want = jpb.beam_search_decode(logits, 4, 0, lengths, log_input=log_input)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]
    assert prefix_beam.prefix_beam_search(logits[0], 3) == jpb.prefix_beam_search(logits[0], 3)


def _logits():
    rng = np.random.default_rng(13)
    logits = rng.standard_normal((3, 20, 5)).astype(np.float32)
    logits[..., 0] += 0.5
    return logits, np.array([20, 15, 7], np.int32)


@pytest.mark.parametrize("decoder,engine", [("argmax", "device"), ("beam", "python"),
                                            ("beam", "device")])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_decoder_matches_jax(decoder, engine, with_lengths):
    logits, lengths = _logits()
    lens = lengths if with_lengths else None
    got = Decoder(decoder, beam_width=4, engine=engine).decode(torch.from_numpy(logits), lens)
    want = jfacade.Decoder(decoder, beam_width=4, engine=engine).decode(logits, lens)
    assert got[1] == want[1]
    if decoder == "argmax":
        assert got[0] is None and want[0] is None
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_decoder_times_and_refusals():
    logits, lengths = _logits()
    sc, strs, times = Decoder("beam", beam_width=4).decode(logits, lengths, return_times=True)
    jsc, jstrs, jtimes = jfacade.Decoder("beam", beam_width=4).decode(logits, lengths,
                                                                     return_times=True)
    assert strs == jstrs and times == jtimes
    assert [len(t) for t in times] == [len(s) for s in strs]
    assert all(t == sorted(t) and all(x < n for x in t) for t, n in zip(times, lengths))
    with pytest.raises(ValueError):
        Decoder("argmax").decode(logits, return_times=True)
    with pytest.raises(ValueError):
        Decoder("beam", engine="python").decode(logits, return_times=True)
    # the native engine (ported since the refusal this case held) gives the
    # device engine's decode, times included
    nsc, nstrs, ntimes = Decoder("beam", beam_width=4, engine="native").decode(
        logits, lengths, return_times=True)
    assert nstrs == jstrs and ntimes == jtimes
    np.testing.assert_allclose(nsc, jsc, rtol=1e-5)
    with pytest.raises(ValueError):
        Decoder("beam", engine="bogus")
    with pytest.raises(ValueError):
        Decoder("bogus")


def narrow_gauss_cfg(save_dir, **training):
    """configs/gauss_quality.json at F=12, one cycle of dilations 1, 2, 4,
    batches of 3 reads of 30-40 bases (never the JAX facade's default
    raw-ctcnet, 2048 features x 140 blocks)."""
    cfg = json.loads((ROOT / "configs" / "gauss_quality.json").read_text())
    cfg["model"]["raw"].update(num_features=12, out_dim=12, num_dilation_blocks=1,
                               dilations=[1, 2, 4])
    cfg["training"].update(save_dir=str(save_dir), batch_size=3, min_sample_length=30,
                           max_sample_length=40, upsampling=3, eval_batches=2, **training)
    return cfg


def _run_evaluate(main, cfg, path, capsys):
    path.write_text(json.dumps(cfg))
    assert main(["evaluate", str(path)]) == 0
    m = LINE.search(capsys.readouterr().out)
    assert m, "no eval line"
    return int(m[1]), float(m[2]), float(m[3])


def pore_cfg(save_dir, **training):
    """A small wavenet-ctc pair (16 levels, pool 2) on the pore datatype."""
    return {"model": {"type": "wavenet-ctc", "base": {"signal_dim": 16, "dilations": [1, 2]},
                      "classifier": {"dilations": [1, 2], "downsample": 2}},
            "training": {"save_dir": str(save_dir), "datatype": "pore", "batch_size": 3,
                         "min_sample_length": 20, "max_sample_length": 26, "seed": 0,
                         "eval_batches": 2, "optim": {"type": "adamax",
                                                      "learning_rate": 2e-4},
                         **training}}


@pytest.mark.parametrize("model_type", ["raw-ctcnet", "wavenet-ctc"])
@pytest.mark.parametrize("decoder", ["beam", "argmax"])
def test_evaluate_matches_jax(tmp_path, capsys, decoder, model_type):
    make_cfg = narrow_gauss_cfg if model_type == "raw-ctcnet" else pore_cfg
    jm = jfacade.Model(model_type, make_cfg(tmp_path))
    params = jm.init(jax.random.PRNGKey(1))
    head = params["ctc"]["out2"]  # an untrained head, shaped away from ties
    head["b"] = head["b"] + jnp.asarray([0.6, 0.9, -0.3, 0.1, -0.7])
    head["w"] = head["w"] * 3.0
    if model_type == "raw-ctcnet":
        params["base"] = dict(params["base"], mean=jnp.asarray([75.0]),
                              var=jnp.asarray([300.0]))
    state = JTrainState.create(params, j_build_optimizer("adamax", 2e-4))
    got = {}
    for side, main in (("jax", jcli.main), ("port", lambda a: cli.main(a + ["--device", "cpu"]))):
        run = tmp_path / side
        if side == "jax":
            j_save_checkpoint(str(run / "ckpts"), state)
        else:
            save_checkpoint(str(run / "ckpts"), bridge.train_state_from_jax(state))
        cfg = make_cfg(run, decoder=decoder, beam_width=4)
        got[side] = _run_evaluate(main, cfg, tmp_path / f"{side}.json", capsys)
    (n, loss, ident), (jn, jloss, jident) = got["port"], got["jax"]
    assert n == jn == 2 and ident == jident
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss) + 1e-4  # + the print's 4 decimals
    assert 0.0 < ident < 1.0


def test_train_resume_then_evaluate(tmp_path, capsys):
    cfg = narrow_gauss_cfg(tmp_path / "run", max_iters=3, print_every=3, save_every=3)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    for _ in range(2):
        assert cli.main(["train", str(path), "--device", "cpu"]) == 0
    ckpts = sorted(int(p.name) for p in (tmp_path / "run" / "ckpts").iterdir())
    assert ckpts == [3, 6]
    assert "resumed from" in (tmp_path / "run" / "logs" / "messages.log").read_text()
    base = torch.load(tmp_path / "run" / "ckpts" / "6" / "state.pt",
                      weights_only=False)["params"]["base"]
    assert float(base["mean"]) > 10 and float(base["var"]) > 10  # moved from (0, 1)
    n, loss, ident = _run_evaluate(lambda a: cli.main(a + ["--device", "cpu"]), cfg, path,
                                   capsys)
    assert n == 2 and np.isfinite(loss) and 0.0 <= ident <= 1.0

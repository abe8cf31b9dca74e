"""Bonito's transformer basecaller (``models.transformer``) and the band
attention's plain version (``ops.window_attention``) on the CPU, at tiny
widths, against the benchmark's plain reference
(``h100_bench/reference/bonito_transformer.py``, which imports nothing of
the port) on seeded random weights, and against float64 arithmetic written
out here.

Tolerances: the port and the reference run the same float32 equations with
sums in another order (the band's softmax over the reached keys against a
dense softmax over every key, RoPE as two halves against rotate_half), so
logits agree to rtol 1e-5 of the largest logit; the CTC loss, summed in
float64 over float32 log-probabilities, to rtol 1e-6; each leaf's gradient,
a sum over the batch's frames, to 1e-4 of that leaf's largest value. The
plain band attention in float64 agrees with the dense float64 softmax to
1e-12."""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench import weights
from h100_bench.counts import bonito_transformer as counts
from h100_bench.reference import bonito_transformer as ref
from h100_bench.reference.ctc import ctc_nll
from wavenet_speech_tpu_torch import cli
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.inference import Basecaller
from wavenet_speech_tpu_torch.models import TransformerBasecaller
from wavenet_speech_tpu_torch.models.transformer import STEM, apply_rotary, rotary
from wavenet_speech_tpu_torch.ops import window_attention as wa
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch.training import JointLoss, TrainState, build_optimizer
from wavenet_speech_tpu_torch.training.trainer import make_ctc_train_step

TINY = {"stem": [[1, 8, 5, 1], [8, 16, 9, 3], [16, 16, 5, 2]], "d_model": 16, "nhead": 2,
        "dim_feedforward": 24, "depth": 2, "attn_window": [5, 6], "upsample": 2,
        "num_labels": 5, "rotary_base": 10000, "norm_eps": 1e-05}
TINY_CFG = {"family": "bonito_transformer", "dtype": "float32", "model": TINY,
            "init": {"kernel_variance": 1.0, "noise": 0.0},
            "training": {"step": "ctc", "preprocess": "batch_standardize",
                         "optimizer": "adamw", "learning_rate": 2e-3, "weight_decay": 0.01}}
PUBLISHED = 76_623_557
ROOT = Path(__file__).resolve().parent.parent


def _tiny(device="cpu"):
    m = TINY
    return TransformerBasecaller(m["stem"], m["d_model"], m["nhead"], m["dim_feedforward"],
                                 m["depth"], tuple(m["attn_window"]), m["upsample"],
                                 m["num_labels"], device=device)


def _batch(B=3, L=300, S=20, seed=0):
    gen = np.random.default_rng(seed)
    return {"signal": torch.from_numpy((80 + 10 * gen.normal(size=(B, L, 1))).astype(np.float32)),
            "labels": torch.from_numpy(gen.integers(1, 5, size=(B, S)).astype(np.int32)),
            "label_lengths": torch.from_numpy(gen.integers(S // 2, S + 1, size=B).astype(np.int32))}


def test_port_matches_the_reference():
    """Logits, the per-logit CTC loss and every leaf's gradient of the port
    (the model and make_ctc_train_step's loss) against the reference's, on
    the benchmark's seeded weights."""
    flat = weights.make(TINY_CFG, 2 ** 31 + 7, "cpu")
    net = _tiny()
    net.load_state_dict(flat)
    batch = _batch()
    x = batch_standardize(batch["signal"])
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in flat.items()}
    logits = torch.func.functional_call(net, leaves, (x,))
    want = ref.serve_logits(leaves, ref.prepare(TINY_CFG, batch)["signal"], TINY_CFG)
    assert logits.shape == want.shape == (3, ref.frames(TINY_CFG, 300), 5)
    torch.testing.assert_close(logits, want, rtol=0,
                               atol=1e-5 * float(want.detach().abs().max()))
    _, loss = JointLoss("ctc").calculate(None, None, logits, batch["labels"],
                                         batch["label_lengths"])
    T = want.shape[1]
    loss_ref = ctc_nll(want, torch.full((3,), T), batch["labels"],
                       batch["label_lengths"]).sum() / T
    gap = float((loss.detach() - loss_ref.detach()).abs() / loss_ref.detach().abs())
    assert gap <= 1e-6
    got = torch.autograd.grad(loss, list(leaves.values()))
    exp = torch.autograd.grad(loss_ref, list(leaves.values()))
    assert len(got) == 2 * 3 + 7 * 2 + 4
    for name, a, b in zip(leaves, got, exp):
        torch.testing.assert_close(a.double(), b.double(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()), msg=name)


def _dense(q, k, v, window):
    """float64 softmax over every key under the band mask: (o, lse)."""
    T, dh = q.shape[1], q.shape[-1]
    s = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(dh)
    i, j = torch.arange(T)[:, None], torch.arange(T)[None, :]
    s = s.masked_fill((j < i - window[0]) | (j > i + window[1]), float("-inf"))
    return torch.einsum("bhij,bjhd->bihd", torch.softmax(s, -1), v), torch.logsumexp(s, -1)


# T below the band, T not a multiple of the block of queries (rows), both
# ends clipped, a one-sided band
@pytest.mark.parametrize("T,window,rows", [(7, (127, 128), 256), (37, (5, 6), 16),
                                          (64, (20, 3), 16), (50, (0, 9), 32)])
def test_plain_window_attention_matches_dense_float64(T, window, rows):
    g = torch.Generator().manual_seed(T)
    q, k, v, do = (torch.randn((2, T, 3, 8), generator=g, dtype=torch.float64)
                   for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, lse = wa.window_attention_ref(*leaves, window, rows)
    dense_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o_d, lse_d = _dense(*dense_leaves, window)
    torch.testing.assert_close(o, o_d, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(lse, lse_d, rtol=1e-12, atol=1e-12)
    for a, b in zip(torch.autograd.grad(o, leaves, do), torch.autograd.grad(o_d, dense_leaves, do)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert wa.band_size(T, window) == counts.band(T, window) == int(
        ((torch.arange(T)[None, :] >= torch.arange(T)[:, None] - window[0])
         & (torch.arange(T)[None, :] <= torch.arange(T)[:, None] + window[1])).sum())
    torch.testing.assert_close(wa.window_attention(q, k, v, window), o.detach())


def test_rope_is_the_explicit_rotation():
    """Dims f and f + dh/2 of frame t turn by t * 10000^(-2f/dh)."""
    T, H, dh = 9, 2, 8
    x = torch.randn((1, T, H, dh), generator=torch.Generator().manual_seed(0))
    got = apply_rotary(x, *rotary(T, dh, "cpu")).double()
    want = torch.empty_like(got)
    for t in range(T):
        for f in range(dh // 2):
            a = t * 10000.0 ** (-2 * f / dh)
            c, s = math.cos(a), math.sin(a)
            x1, x2 = x[0, t, :, f].double(), x[0, t, :, f + dh // 2].double()
            want[0, t, :, f] = c * x1 - s * x2
            want[0, t, :, f + dh // 2] = s * x1 + c * x2
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * T)


@pytest.mark.parametrize("L", [1, 7, 100, 301, 12288])
def test_output_length_counts_the_frames(L):
    net = _tiny()
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        frames = net(torch.randn((1, L, 1))).shape[1]
    assert frames == net.output_length(L) == ref.frames(TINY_CFG, L)
    assert list(net.output_length(np.array([L, L + 6]))) == [frames, net.output_length(L + 6)]
    # the published stem: a chunk of 12,288 samples is T = 1,024 frames
    assert TransformerBasecaller(device="meta").frames(12288) == 1024


def _tiny_model_cfg(**training):
    return {"model": {"type": "transformer-ctc",
                      "transformer": {k: TINY[k] for k in ("stem", "d_model", "nhead",
                                                           "dim_feedforward", "depth",
                                                           "attn_window")}},
            "training": training}


def test_model_trains_through_the_ctc_step_and_basecalls():
    """Model("transformer-ctc") through one make_ctc_train_step with AdamW
    and through Basecaller.__call__; the long-read path refuses it."""
    model = Model("transformer-ctc", _tiny_model_cfg(), device="cpu").init(0)
    tx = build_optimizer("adamw", 2e-3, weight_decay=0.01)
    net = model.model_ctc
    step = make_ctc_train_step(net, tx, preprocess=batch_standardize)
    state = TrainState.create({k: v.detach().clone() for k, v in net.state_dict().items()}, tx)
    new, m = step(state, _batch())
    assert math.isfinite(float(m["total_loss"])) and int(m["skipped_nonfinite"]) == 0
    assert all(not torch.equal(new.params[k], state.params[k]) for k in state.params)
    net.load_state_dict(new.params)
    reads = _batch(B=2, L=250)["signal"].numpy()
    caller = Basecaller(model, beam_width=3, logit_length_fn=model.output_length, device="cpu")
    seqs, scores = caller(reads, lengths=np.array([250, 180]))
    assert len(seqs) == 2 and all(math.isfinite(s) for s in scores)
    with pytest.raises(ValueError, match="strided stem"):
        caller.basecall_long(reads[0], chunk_len=128)


def test_cli_trains_the_transformer(tmp_path):
    cfg = _tiny_model_cfg(datatype="raw-gauss", loss="ctc", batch_size=2, min_sample_length=20,
                          max_sample_length=26, upsampling=6, max_iters=3, print_every=3,
                          save_every=3, save_dir=str(tmp_path), seed=0,
                          optim={"type": "adamw", "learning_rate": 2e-3, "wd": 0.01})
    result = cli.train_with_result(cfg, "cpu")
    assert result["steps"] == 3 and math.isfinite(result["train_loss"])
    assert (tmp_path / "ckpts" / "3").is_dir()


def test_forward_marks_its_spans():
    net = _tiny()
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        net(torch.randn((1, 64, 1)))
    names = [e.name for e in prof.events() if e.name.startswith("tx.")]
    assert set(names) == {"tx.stem", "tx.attention", "tx.norm", "tx.mlp", "tx.head"}
    assert names.count("tx.attention") == TINY["depth"]
    assert names.count("tx.norm") == 2 * TINY["depth"]


def test_parameter_count_is_the_formula():
    """At Bonito sup v5's widths: 76,623,557 parameters in 140 tensors,
    the reference's shapes, and the formula: the stem, 18 layers of
    Wqkv + out_proj + W1 + W2 + two norms, the upsample, the head."""
    net = TransformerBasecaller(device="meta")
    d, f, depth = 512, 2048, 18
    formula = sum(k * ci * co + co for ci, co, k, _ in STEM) \
        + depth * (3 * d * d + d * d + d + 2 * d * f + f * d + 2 * d) \
        + (d * 2 * d + 2 * d) + (d * 5 + 5)
    cfg = json.loads((ROOT / "h100_bench" / "configs" / "bonito_sup_v5.json").read_text())
    shapes = ref.param_shapes(cfg)
    assert sum(p.numel() for p in net.parameters()) == formula == PUBLISHED \
        == sum(math.prod(s) for s in shapes.values())
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == shapes
    assert len(shapes) == 140
    assert cfg["assumed"]["parameters"] == PUBLISHED
    # a chunk's forward: 167.2 GFLOP (the layers' products 154.6, the band
    # 9.1, the stem 2.4, the upsample and head 1.1)
    assert counts.read_flops(cfg, 12288) == pytest.approx(167.153e9, rel=1e-5)

"""The benchmark's plain reference against the port's plain CPU path at a
small size: each configuration's forward, the loss, the first gradients,
the update, the CTC, and the beam."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h100_bench import gen, reference, weights
from h100_bench.reference import nn
from h100_bench.reference.beam import log_softmax64, prefix_beam
from h100_bench.reference.ctc import ctc_nll
from h100_bench.tests.conftest import TINY_CONFIGS, TINY_TRAFFIC


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_forward_matches_port(name):
    from h100_bench.port import family

    cfg = TINY_CONFIGS[name]
    flat = weights.make(cfg, 11, "cpu")
    model = family(cfg["family"]).build(cfg, "cpu")
    family(cfg["family"]).load(model, flat)
    g = torch.Generator().manual_seed(0)
    if cfg["family"] == "raw_ctcnet":
        x = torch.randn(3, 40, 1, generator=g)
    else:
        x = torch.nn.functional.one_hot(torch.randint(0, 8, (3, 48), generator=g), 8).float()
    with torch.no_grad():
        got, want = model(x), reference.family(cfg["family"]).serve_logits(flat, x, cfg)
    assert got.shape == want.shape == (3, reference.family(cfg["family"]).frames(cfg, x.shape[1]), 5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell", ["tiny.train.wavenet_ctc", "tiny.train.raw_ctcnet"])
def test_train_steps_match_port(tiny_bench, cell):
    """The first three steps (loss, first gradient, change) of the port's
    train step and the reference's, in float32 on the CPU."""
    from h100_bench import loops
    from h100_bench.compare import train_numbers

    c = tiny_bench.cell(cell)
    cfg, mix = tiny_bench.config(c["config"]), tiny_bench.traffic(c["traffic"])
    loop = loops.get("train")(cfg, mix, 2 ** 31 + 5, torch.device("cpu"))
    loop.setup()
    loop.release()
    ref = loop.reference()
    numbers = train_numbers(loop.prog, ref)
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-4
    assert numbers["update_gap"] < 1e-3
    assert len(ref["losses"]) == 3 and all(np.isfinite(ref["losses"]))
    assert set(ref["grad_norms"]) == set(loop.prog["grad_norms"])


def test_ctc_matches_port():
    from wavenet_speech_tpu_torch.ops.ctc import ctc_loss_per_seq

    g = torch.Generator().manual_seed(1)
    logits = torch.randn(3, 30, 5, generator=g)
    labels = torch.randint(1, 5, (3, 9), generator=g, dtype=torch.int32)
    label_lengths = torch.tensor([9, 7, 4], dtype=torch.int32)
    lengths = torch.tensor([30, 30, 25], dtype=torch.int32)
    want = ctc_loss_per_seq(logits, lengths, labels, label_lengths).double()
    got = ctc_nll(logits, lengths, labels, label_lengths)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_standardize_matches_port():
    from wavenet_speech_tpu_torch.ops.norm import batch_standardize

    x = torch.as_tensor(gen.make(TINY_TRAFFIC["tiny_train_raw"], 3)[0]["signal"])
    torch.testing.assert_close(nn.standardize(x), batch_standardize(x), rtol=1e-5, atol=1e-5)


def test_beam_matches_port():
    """The reference's prefix beam and the port's batched beam (its plain
    CPU version) agree on the best prefix and its score."""
    from wavenet_speech_tpu_torch.decoding.ctc_beam_device import ctc_beam_search

    g = torch.Generator().manual_seed(2)
    logits = 2.0 * torch.randn(4, 40, 5, generator=g)
    prefixes, plens, scores = ctc_beam_search(logits, beam_width=5, blank=0)
    for b in range(4):
        best, score = prefix_beam(log_softmax64(logits[b].numpy()), 5)[0]
        assert tuple(prefixes[b, 0, :plens[b, 0]].tolist()) == best
        assert abs(float(scores[b, 0]) - score) < 1e-4


def test_weights_follow_the_seed():
    cfg = TINY_CONFIGS["tiny_raw_ctcnet"]
    a, b, c = (weights.make(cfg, s, "cpu") for s in (7, 7, 8))
    assert set(a) == set(reference.family(cfg["family"]).param_shapes(cfg))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stack.blocks.0.gate_w"], c["stack.blocks.0.gate_w"])
    eye = torch.eye(8, 8)
    assert (a["stack.bottlenecks.0.w"] - eye).abs().max() < 1e-3

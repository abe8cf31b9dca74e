"""The label-synchronous beam (decoding/labelsync.py) against the JAX
package's: hypotheses equal, best scores within rtol 1e-5 (float32 sums of
the same softmax probabilities; the softmax of torch and XLA may differ
in the last bit), the per-step beam state of ``_advance_scan`` equal to
JAX's vmapped scan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.decoding import labelsync as jlabelsync
from wavenet_speech_tpu_torch.decoding import Beam, BeamSearchDecoder
from wavenet_speech_tpu_torch.decoding.labelsync import DEFAULT_BEAM_MAP, _advance_scan

RTOL = 1e-5


def _decode_both(logits, W, channels_last=False, cap_seqs=False):
    B, C = logits.shape[0], logits.shape[-1 if channels_last else 1]
    kw = dict(beam_width=W, cap_seqs=cap_seqs)
    got = BeamSearchDecoder(B, C, device="cpu", **kw).decode(logits, channels_last)
    want = jlabelsync.BeamSearchDecoder(B, C, **kw).decode(logits, channels_last)
    return got, want


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("cap_seqs", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_matches_jax(channels_last, cap_seqs, seed):
    rng = np.random.default_rng(seed)
    B, C, L, W = 3, 7, 9, 4
    shape = (B, L, C) if channels_last else (B, C, L)
    logits = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    (probas, hyps), (jprobas, jhyps) = _decode_both(logits, W, channels_last, cap_seqs)
    assert hyps == jhyps
    np.testing.assert_allclose(probas, jprobas, rtol=RTOL)
    if cap_seqs:   # <s> opens every hypothesis; </s> at the end stops any beam not done
        assert all(h[0] == DEFAULT_BEAM_MAP["<s>"] for h in hyps)


def test_advance_scan_matches_jax():
    """The whole beam state, step by step: scores, backpointers, labels and
    done flags, for a batch of sequences of which some stop early."""
    rng = np.random.default_rng(2)
    B, T, C, W = 4, 12, 7, 5
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    logits[..., 6] -= 6.0                          # </s> unlikely but at two spikes
    logits[1, 4, 6] = logits[3, 7, 6] = 12.0
    probs = torch.softmax(torch.from_numpy(logits), -1)
    got = _advance_scan(probs, W, 6)
    want = jax.vmap(lambda p: jlabelsync._advance_scan(p, W, 6))(jnp.asarray(probs.numpy()))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL)
    done = got[3].numpy()
    assert done[1, 4] and not done[1, 3] and done[3, 7] and not done[3, 6]


def test_stops_at_end_of_sequence():
    """A distribution that strongly prefers </s> at step 3 stops there: the
    hypothesis is the 4 steps t = 0..3, ending in </s>, and the beam is done."""
    C, L, W = 7, 8, 3
    logits = np.zeros((1, C, L), np.float32)
    logits[0, 1, :] = 2.0
    logits[0, 6, 3] = 10.0
    (_, hyps), (_, jhyps) = _decode_both(logits, W)
    assert hyps == jhyps and len(hyps[0]) == 4 and hyps[0][-1] == 6
    probs = torch.softmax(torch.from_numpy(logits).transpose(1, 2), -1)
    beam = Beam(*(a[0].numpy() for a in _advance_scan(probs, W, 6)))
    assert beam.done and beam.n_steps == 4
    score, k = beam.get_best()
    assert beam.get_hyp(int(k)) == hyps[0]

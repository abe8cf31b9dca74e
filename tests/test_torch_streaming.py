"""The port's streaming beam (decoding/streaming.py) against the JAX
package's on the CPU, on peaked log-probs made from a seed (sharp and
blank-dominant like a trained CTC model's output, as
tests/test_streaming_beam.py makes them). The port's beam runs its plain
version here (beam_search_ref); on the card the same calls launch B6.

Held equal to JAX: the decoded labels, their emission times, the
committed labels and times, ``saturated_chunks``, and the carried state
after every chunk (live rows up to their plens; past plens a row holds
the labels its commits rolled out, which nothing reads). Scores within
1e-3, the beam tests' tolerance."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.decoding import ctc_beam_search_jax
from wavenet_speech_tpu.decoding import streaming as jstreaming
from wavenet_speech_tpu_torch.decoding import streaming
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import NEG_INF, ctc_beam_search
from wavenet_speech_tpu_torch.decoding.streaming import (StreamingBeam, StreamingBeamBatch,
                                                         streaming_beam_decode)

SCORE_ATOL = 1e-3


def peaked_log_probs(T, C=5, seed=0, sharp=3.0, blank_frac=0.8, blank_boost=None):
    rng = np.random.default_rng(seed)
    logits = (sharp * rng.standard_normal((T, C))).astype(np.float32)
    blank_frames = rng.random(T) < blank_frac
    logits[blank_frames, 0] += 2 * sharp
    if blank_boost is not None:  # a large alphabet: make blank frames dominant again
        logits[logits[:, 0] > logits[:, 1:].max(axis=1) - 3.0, 0] += blank_boost
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def assert_states_equal(got, want):
    """Batched port state (B, W, S) against JAX's, live rows up to plens."""
    prefixes, plens, pb, pnb, times = (np.asarray(x) for x in want)
    gp, gl, gpb, gpnb, gt = (x.cpu().numpy() for x in got)
    np.testing.assert_array_equal(gl, plens)
    np.testing.assert_array_equal(gpb, pb)
    np.testing.assert_array_equal(gpnb, pnb)
    live = np.logaddexp(pb, pnb) > NEG_INF / 2
    for idx in zip(*np.nonzero(live)):
        n = plens[idx]
        np.testing.assert_array_equal(gp[idx][:n], prefixes[idx][:n])
        np.testing.assert_array_equal(gt[idx][:n], times[idx][:n])


def assert_decoded_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert abs(got[1] - want[1]) < SCORE_ATOL


def monolithic(lp, W=7, prune=None):
    p, n, s, t = ctc_beam_search(torch.tensor(lp)[None], beam_width=W, log_input=True,
                                 return_times=True, prune=prune)
    k = int(n[0, 0])
    return p[0, 0, :k].numpy(), float(s[0, 0]), t[0, 0, :k].numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_matches_jax_and_monolithic(seed):
    lp = peaked_log_probs(900, seed=seed)
    got = streaming_beam_decode(lp, beam_width=7, label_window=256, chunk_frames=128,
                                device="cpu")
    assert_decoded_equal(got, jstreaming.streaming_beam_decode(
        lp, beam_width=7, label_window=256, chunk_frames=128))
    assert_decoded_equal(got, monolithic(lp))
    assert len(got[0]) > 50 and np.all(np.diff(got[2]) >= 0)


def test_streaming_ragged_tail_and_logits_input():
    """900 % 256 != 0: the padded carry-through tail chunk; log_input=False
    log-softmaxes first."""
    rng = np.random.default_rng(3)
    logits = peaked_log_probs(900, seed=3) + rng.standard_normal((1, 5)).astype(np.float32)
    kw = dict(beam_width=7, label_window=256, chunk_frames=256, log_input=False)
    got = streaming_beam_decode(torch.from_numpy(logits), **kw)
    assert_decoded_equal(got, jstreaming.streaming_beam_decode(logits, **kw))


def test_streaming_beam_state_and_commits_match_jax():
    """Chunk by chunk: the carried state, the committed labels and times,
    and the window's occupancy stay equal to JAX's, and the window stays
    far below the decoded length."""
    lp = peaked_log_probs(1000, seed=4)
    sb = StreamingBeam(beam_width=7, label_window=128, device="cpu")
    jsb = jstreaming.StreamingBeam(beam_width=7, label_window=128)
    for s in range(0, 1000, 125):
        sb.feed(lp[s: s + 125])
        jsb.feed(lp[s: s + 125])
        assert_states_equal(sb.state, tuple(np.asarray(x)[None] for x in jsb.state))
        np.testing.assert_array_equal(sb.committed, jsb.committed)
        np.testing.assert_array_equal(sb.committed_times, jsb.committed_times)
    assert sb.saturated_chunks == jsb.saturated_chunks == 0
    labels, _, _ = sb.finalize()
    assert len(sb.committed) > 100 and int(sb.state[1].max()) < 128 < len(labels)
    assert_decoded_equal(sb.finalize(), jsb.finalize())


@pytest.mark.parametrize("batched", [False, True])
def test_saturated_window_matches_jax(batched):
    """A window too small for the labels a chunk adds: extensions are
    masked, the decode is length-capped, and the labels, times and
    saturated_chunks are still JAX's."""
    lp = peaked_log_probs(600, seed=5, blank_frac=0.3)
    kw = dict(beam_width=5, label_window=24)
    if batched:
        lps = np.stack([lp, peaked_log_probs(600, seed=6, blank_frac=0.3)])
        sb = StreamingBeamBatch(2, [600, 450], device="cpu", **kw)
        jsb = jstreaming.StreamingBeamBatch(2, np.asarray([600, 450], np.int32), **kw)
        for s in range(0, 600, 100):
            sb.feed(lps[:, s: s + 100])
            jsb.feed(lps[:, s: s + 100])
        for got, want in zip(sb.finalize(), jsb.finalize()):
            assert_decoded_equal(got, want)
    else:
        sb = StreamingBeam(device="cpu", **kw)
        jsb = jstreaming.StreamingBeam(**kw)
        for s in range(0, 600, 100):
            sb.feed(lp[s: s + 100])
            jsb.feed(lp[s: s + 100])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got, want = sb.finalize(), jsb.finalize()
        assert any("saturated" in str(w.message) for w in caught)
        assert_decoded_equal(got, want)
    assert sb.saturated_chunks == jsb.saturated_chunks > 0


def test_window_capped_inside_a_chunk_is_not_counted_as_in_jax():
    """A fault of the reference, kept: JAX counts a chunk as saturated only
    when the window is full AFTER its commit (streaming.py:107-109, 222-224). A
    window that fills inside a chunk caps the decode, the commit then frees
    room, and the count stays 0 with no warning. The port gives the same
    labels and the same count; both fall short of the monolithic beam."""
    lp = peaked_log_probs(400, seed=1)
    sb = StreamingBeam(beam_width=5, label_window=32, device="cpu")
    jsb = jstreaming.StreamingBeam(beam_width=5, label_window=32)
    for s in range(0, 400, 128):
        sb.feed(lp[s: s + 128])
        jsb.feed(lp[s: s + 128])
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no saturation warning from either
        got, want = sb.finalize(), jsb.finalize()
    assert_decoded_equal(got, want)
    assert sb.saturated_chunks == jsb.saturated_chunks == 0
    full = monolithic(lp, W=5)[0]
    assert len(got[0]) < len(full) - 40  # 78 labels of 129


def test_batched_streaming_ragged_lengths_match_jax():
    """StreamingBeamBatch, reads of 900, 700 and 512 frames on one grid,
    against JAX's batch and the port's per-read decoder."""
    B, T = 3, 900
    lengths = np.asarray([900, 700, 512], np.int32)
    lp = np.stack([peaked_log_probs(T, seed=40 + b) for b in range(B)])
    sbb = StreamingBeamBatch(B, lengths, beam_width=7, label_window=256, device="cpu")
    jsbb = jstreaming.StreamingBeamBatch(B, lengths, beam_width=7, label_window=256)
    for s in range(0, T, 300):
        sbb.feed(lp[:, s: s + 300])
        jsbb.feed(lp[:, s: s + 300])
        assert_states_equal(sbb.state, jsbb.state)
        for a, b in zip(sbb.committed_times, jsbb.committed_times):
            np.testing.assert_array_equal(a, b)
    outs = sbb.finalize()
    for got, want in zip(outs, jsbb.finalize()):
        assert_decoded_equal(got, want)
    assert sbb.saturated_chunks == jsbb.saturated_chunks == 0
    for b in range(B):
        assert_decoded_equal(outs[b], streaming_beam_decode(
            lp[b, : lengths[b]], beam_width=7, label_window=256, chunk_frames=300,
            device="cpu"))


def test_cutoff_top_n_matches_jax():
    """cutoff_top_n = prune on a 30-label alphabet, single and batched,
    against JAX's streaming and the pruned monolithic beam."""
    lp = peaked_log_probs(600, C=30, seed=0, blank_boost=12.0)
    got = streaming_beam_decode(lp, beam_width=7, label_window=256, chunk_frames=128,
                                cutoff_top_n=8, device="cpu")
    assert_decoded_equal(got, jstreaming.streaming_beam_decode(
        lp, beam_width=7, label_window=256, chunk_frames=128, cutoff_top_n=8))
    prefixes, plens, scores = ctc_beam_search_jax(jnp.asarray(lp)[None], beam_width=7,
                                                  max_label_len=600, prune=8)
    n = int(plens[0, 0])
    np.testing.assert_array_equal(got[0], np.asarray(prefixes)[0, 0, :n])
    lps = np.stack([lp, peaked_log_probs(600, C=30, seed=1, blank_boost=12.0)])
    sbb = StreamingBeamBatch(2, [600, 600], beam_width=7, label_window=256, cutoff_top_n=8,
                             device="cpu")
    jsbb = jstreaming.StreamingBeamBatch(2, np.asarray([600, 600], np.int32), beam_width=7,
                                         label_window=256, cutoff_top_n=8)
    for s in range(0, 600, 200):
        sbb.feed(lps[:, s: s + 200])
        jsbb.feed(lps[:, s: s + 200])
    for a, b in zip(sbb.finalize(), jsbb.finalize()):
        assert_decoded_equal(a, b)


def test_commit_keeps_a_label_and_rolls_like_numpy():
    """The commit on a hand-made state: the common prefix below the
    shortest live row minus one, dead rows ignored, rows rolled as np.roll."""
    W, S = 3, 8
    prefixes = torch.tensor([[[1, 2, 3, 4, 0, 0, 0, 0], [1, 2, 3, 1, 2, 0, 0, 0],
                              [4, 4, 4, 4, 4, 4, 4, 4]],
                             [[1, 2, 0, 0, 0, 0, 0, 0], [1, 3, 0, 0, 0, 0, 0, 0],
                              [1, 2, 3, 0, 0, 0, 0, 0]]], dtype=torch.int32)
    times = prefixes * 10
    plens = torch.tensor([[4, 5, 8], [2, 2, 3]], dtype=torch.int32)
    pb = torch.tensor([[0.0, -1.0, NEG_INF], [-1.0, -2.0, -3.0]])
    pnb = torch.full((2, W), NEG_INF)
    state, k, labels, tms, saturated = streaming.commit((prefixes, plens, pb, pnb, times), S)
    assert k.tolist() == [3, 1] and saturated.tolist() == [False, False]
    assert labels[0].tolist() == [1, 2, 3] and labels[1, :1].tolist() == [1]
    assert tms[0].tolist() == [10, 20, 30]
    np.testing.assert_array_equal(state[0][0].numpy(), np.roll(prefixes[0].numpy(), -3, 1))
    np.testing.assert_array_equal(state[4][1].numpy(), np.roll(times[1].numpy(), -1, 1))
    assert state[1].tolist() == [[1, 2, 5], [1, 1, 2]]


def test_streaming_needs_a_device():
    if not torch.cuda.is_available():
        for make in (lambda: StreamingBeam(), lambda: StreamingBeamBatch(1, [4]),
                     lambda: streaming_beam_decode(np.zeros((4, 5), np.float32))):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    with pytest.raises(ValueError, match="lengths"):
        StreamingBeamBatch(2, [4], device="cpu")

"""The port's plain beam search against the JAX XLA beam
(``ctc_beam_search_jax``) and the Pallas beam kernel in interpret mode, at
the cases of tests/test_pallas_beam.py, and its beam state in and out
against JAX's ``beam_scan`` (a state from mid-decode, frames from t0).
Live beams must hold equal prefixes and lengths (and times, where asked),
with scores within 1e-3 absolute."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.decoding.ctc_beam_device import beam_finalize as jfinalize
from wavenet_speech_tpu.decoding.ctc_beam_device import beam_init as jinit
from wavenet_speech_tpu.decoding.ctc_beam_device import beam_scan as jscan
from wavenet_speech_tpu.decoding.ctc_beam_device import ctc_beam_search_jax
from wavenet_speech_tpu.decoding import greedy as jgreedy
from wavenet_speech_tpu.ops.pallas.attic.beam import beam_search_pallas
from wavenet_speech_tpu_torch.decoding import greedy as tgreedy
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (
    NEG_INF, beam_finalize, beam_init, beam_scan, beam_search_kernel,
    beam_search_ref, ctc_beam_search)


def _lp(B, T, C, seed=0, sharp=2.0, blank_frac=0.6):
    rng = np.random.default_rng(seed)
    logits = (sharp * rng.standard_normal((B, T, C))).astype(np.float32)
    logits[:, rng.random(T) < blank_frac, 0] += sharp
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def _assert_live_equal(got, want, W, check_times):
    """got/want: finalized (prefixes, plens, scores, times) as numpy."""
    p1, l1, s1, t1 = got
    p0, l0, s0, t0 = want
    n_live = 0
    for b in range(p0.shape[0]):
        for r in range(W):
            if s0[b, r] <= NEG_INF / 2:
                break
            n_live += 1
            assert abs(s1[b, r] - s0[b, r]) < 1e-3, (b, r, s1[b, r], s0[b, r])
            n = int(l0[b, r])
            assert int(l1[b, r]) == n, (b, r)
            np.testing.assert_array_equal(p1[b, r, :n], p0[b, r, :n])
            if check_times:
                np.testing.assert_array_equal(t1[b, r, :n], t0[b, r, :n])
    assert n_live > 0


CASES = {  # (B, T, C, seed), lengths, W, S, prune — tests/test_pallas_beam.py
    "dna": ((2, 100, 5, 0), [100, 77], 7, 64, None),
    "speech_alphabet": ((2, 60, 30, 1), [60, 60], 8, 32, None),
    "pruned": ((1, 60, 30, 2), [60], 8, 32, 12),
    "times": ((1, 80, 5, 3), [80], 5, 48, None),
}


def _torch_beam(lp, lengths, W, S, prune):
    out = ctc_beam_search(torch.from_numpy(lp), torch.tensor(lengths),
                          beam_width=W, max_label_len=S, log_input=True,
                          return_times=True, prune=prune)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_beam_matches_xla(case):
    shape, lengths, W, S, prune = CASES[case]
    lp = _lp(*shape)
    got = _torch_beam(lp, lengths, W, S, prune)
    want = [np.asarray(o) for o in ctc_beam_search_jax(
        lp, lengths=jnp.asarray(lengths), beam_width=W, max_label_len=S,
        log_input=True, return_times=True, prune=prune)]
    _assert_live_equal(got, want, W, check_times=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_beam_matches_pallas_interpret(case):
    shape, lengths, W, S, prune = CASES[case]
    lp = _lp(*shape)
    got = _torch_beam(lp, lengths, W, S, prune)
    state = beam_search_pallas(jnp.asarray(lp), np.asarray(lengths, np.int32),
                               beam_width=W, max_label_len=S, prune=prune,
                               interpret=True)
    want = [np.asarray(o) for o in jax.vmap(jfinalize)(state)]
    _assert_live_equal(got, want, W, check_times=True)


def test_beam_saturated_label_cap_and_softmax_input():
    """max_label_len smaller than the decode needs, and logits (softmaxed
    inside) rather than log-probs."""
    rng = np.random.default_rng(7)
    logits = (2 * rng.standard_normal((2, 50, 5))).astype(np.float32)
    got = [o.numpy() for o in ctc_beam_search(
        torch.from_numpy(logits), beam_width=7, max_label_len=5,
        return_times=True)]
    want = [np.asarray(o) for o in ctc_beam_search_jax(
        logits, beam_width=7, max_label_len=5, return_times=True)]
    assert got[1].max() == 5
    _assert_live_equal(got, want, 7, check_times=True)


def test_beam_finalize_is_stable_on_ties():
    """Equal scores keep slot order, as jnp.argsort does."""
    pb = torch.tensor([[-1.0, -2.0, -1.0, NEG_INF]])
    state = (torch.arange(4, dtype=torch.int32).reshape(1, 4, 1),
             torch.ones((1, 4), dtype=torch.int32), pb,
             torch.full((1, 4), NEG_INF), torch.zeros((1, 4, 1), dtype=torch.int32))
    prefixes, _, scores, _ = beam_finalize(state)
    assert prefixes[0, :, 0].tolist() == [0, 2, 1, 3]


def test_kernel_wrapper_refuses_cpu_tensors():
    lp = torch.from_numpy(_lp(1, 10, 5))
    with pytest.raises(ValueError, match="CUDA"):
        beam_search_kernel(lp, torch.tensor([10]), beam_width=4, max_label_len=8)
    # the plain version is what a CPU tensor gets
    state = beam_search_ref(lp, torch.tensor([10]), beam_width=4, max_label_len=8)
    assert state[0].shape == (1, 4, 8)


@pytest.mark.parametrize("lengths", [None, [30, 17]])
def test_greedy_matches_jax(lengths):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 30, 5)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths)
    assert tgreedy.greedy_ctc_decode(torch.from_numpy(logits), lens) == \
        jgreedy.greedy_ctc_decode(jnp.asarray(logits), lens)
    np.testing.assert_array_equal(
        tgreedy.argmax_decode(torch.from_numpy(logits)).numpy(),
        np.asarray(jgreedy.argmax_decode(jnp.asarray(logits))))


def _jax_scan(state, lp, t0, lengths, prune):
    """JAX's beam_scan over frames with global indices t0 + arange(T),
    vmapped over the batch; numpy in and out."""
    ts = t0 + jnp.arange(lp.shape[1])
    fn = lambda st, x, n: jscan(st, x, ts, n, blank=0, prune=prune)
    out = jax.vmap(fn)(tuple(jnp.asarray(x) for x in state), jnp.asarray(lp),
                       jnp.asarray(lengths))
    return [np.array(x) for x in out]


def _finalized(state):
    return [np.asarray(o) for o in jax.vmap(jfinalize)(tuple(jnp.asarray(x) for x in state))]


@pytest.mark.parametrize("case", ["dna", "pruned", "speech_alphabet"])
def test_plain_beam_scan_from_a_state_matches_jax(case):
    """From a mid-decode state (JAX's, after frames [0, t1)), the port's
    beam_scan with t0=t1 equals JAX's beam_scan with ts = t1 + arange."""
    shape, lengths, W, S, prune = CASES[case]
    lp = _lp(*shape)
    B, T, _ = lp.shape
    t1 = T // 3
    init = jax.vmap(lambda _: jinit(W, S))(jnp.arange(B))
    mid = _jax_scan(init, lp[:, :t1], 0, lengths, prune)
    assert int(mid[1].max()) > 0
    want = _jax_scan(mid, lp[:, t1:], t1, lengths, prune)
    got = beam_scan(tuple(torch.tensor(x) for x in mid), torch.from_numpy(lp[:, t1:]),
                    torch.tensor(lengths), t0=t1, prune=prune)
    _assert_live_equal([o.numpy() for o in beam_finalize(got)], _finalized(want), W,
                       check_times=True)


def test_plain_beam_scan_carries_frames_past_the_length():
    """t0 at or past a sequence's length carries its state through, as
    JAX's ts >= length does; the other sequence runs on."""
    shape, _, W, S, _ = CASES["dna"]
    lp = _lp(*shape)
    mid = beam_search_ref(torch.from_numpy(lp[:, :50]), torch.tensor([100, 77]),
                          beam_width=W, max_label_len=S)
    lengths = torch.tensor([100, 50])
    got = beam_search_ref(torch.from_numpy(lp[:, 50:]), lengths, beam_width=W,
                          max_label_len=S, state=mid, t0=50)
    want = _jax_scan([x.numpy() for x in mid], lp[:, 50:], 50, lengths.numpy(), None)
    for g, m in zip(got, mid):
        np.testing.assert_array_equal(g[1].numpy(), m[1].numpy())  # carried
    _assert_live_equal([o.numpy() for o in beam_finalize(got)], _finalized(want), W,
                       check_times=True)


@pytest.mark.parametrize("case", ["dna", "pruned", "times"])
def test_plain_chained_calls_equal_one_call(case):
    """Frames [0, t1), then [t1, T) from the returned state with t0=t1: the
    bits of one call."""
    shape, lengths, W, S, prune = CASES[case]
    lp = torch.from_numpy(_lp(*shape))
    lengths = torch.tensor(lengths)
    kw = dict(beam_width=W, max_label_len=S, prune=prune)
    t1 = lp.shape[1] // 2
    mid = beam_search_ref(lp[:, :t1], lengths, **kw)
    two = beam_search_ref(lp[:, t1:], lengths, state=mid, t0=t1, **kw)
    for x, y in zip(two, beam_search_ref(lp, lengths, **kw)):
        assert torch.equal(x, y)


def test_plain_call_without_a_state_is_unchanged():
    """No state and t0=0 is the decode from beam_init, which the tests
    above hold against JAX; a state of the wrong shape is refused."""
    shape, lengths, W, S, _ = CASES["times"]
    lp = torch.from_numpy(_lp(*shape))
    lengths = torch.tensor(lengths)
    got = beam_search_ref(lp, lengths, beam_width=W, max_label_len=S)
    want = beam_scan(beam_init(1, W, S), lp, lengths)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="beam state"):
        beam_search_ref(lp, lengths, beam_width=W, max_label_len=S + 1, state=want)

"""The port's Basecaller (beam W=7, and greedy) against the JAX Basecaller
on the same small wavenet-ctc model and the same one-hot signals, with
true lengths and a logit_length_fn, on the CPU. Decoded strings must be
equal, beam scores within 1e-3. The staging buffer a Basecaller reuses
across calls must hand the model the bits a fresh one does."""
import jax
import numpy as np
import pytest
import torch

from wavenet_speech_tpu import facade as jfacade
from wavenet_speech_tpu.inference import Basecaller as JBasecaller
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.inference import Basecaller

LEVELS = 16


def _cfg():
    return {"model": {"base": {"signal_dim": LEVELS, "dilations": [1, 2, 4, 8]},
                      "classifier": {"dilations": [1, 2], "downsample": 4}}}


@pytest.fixture(scope="module")
def pair():
    jm = jfacade.Model("wavenet-ctc", _cfg())
    params = jm.init(jax.random.PRNGKey(0))
    tm = Model("wavenet-ctc", _cfg(), device="cpu").load_jax(
        jax.tree_util.tree_map(np.asarray, params))

    class _Pipe:  # what the CLI's basecall hands the JAX Basecaller
        def apply(self, p, x):
            return jm.predict(p, x)[1]

    return _Pipe(), params, tm


def _signals(B=3, L=150, seed=0):
    lv = np.random.default_rng(seed).integers(0, LEVELS, size=(B, L))
    return np.eye(LEVELS, dtype=np.float32)[lv]


@pytest.mark.parametrize("beam_width", [7, 0])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_basecaller_matches_jax(pair, beam_width, with_lengths):
    pipe, params, tm = pair
    sig = _signals()
    lengths = np.asarray([150, 121, 90]) if with_lengths else None
    kw = dict(beam_width=beam_width, pad_to_multiple=64,
              logit_length_fn=lambda l: l // 4)
    seqs, scores = Basecaller(tm, device="cpu", **kw)(sig, lengths)
    jseqs, jscores = JBasecaller(model=pipe, params=params, **kw)(sig, lengths)
    assert seqs == jseqs
    assert all(s and set(s) <= set("AGCT") for s in seqs)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-3)


def _record_calls(model):
    """(the model's input, its logits) of each forward, copied; and the
    hook's handle."""
    seen = []
    return seen, model.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].clone(), out.clone())))


def test_bucket_padding_is_not_decoded(pair):
    """A signal of 150 (bucketed to 192) decodes as the same signal padded
    by hand with its true lengths given."""
    _, _, tm = pair
    caller = Basecaller(tm, beam_width=7, pad_to_multiple=64, device="cpu",
                        logit_length_fn=lambda l: l // 4)
    sig = _signals(B=2)
    seen, hook = _record_calls(tm)
    try:
        a, sa = caller(sig)
    finally:
        hook.remove()
    padded = np.pad(sig, ((0, 0), (0, 42), (0, 0)))
    b, sb = caller(padded, lengths=np.full((2,), 150))
    assert a == b and sa == sb
    assert torch.equal(seen[0][0], torch.from_numpy(padded))


@pytest.mark.parametrize("beam_width", [7, 0])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_staging_buffer_is_reused(pair, beam_width, with_lengths):
    """Long (bucket 256), short (128) and long again through one
    Basecaller: each call hands the model the signal, then zeros to the
    bucket (a longer call's rows stay in the buffer), and gives a fresh
    Basecaller's logits, strings and scores bit for bit; the staging
    buffer is allocated once. A call past its capacity grows it."""
    _, _, tm = pair
    kw = dict(beam_width=beam_width, pad_to_multiple=128, device="cpu",
              logit_length_fn=lambda l: l // 4)
    caller = Basecaller(tm, **kw)
    seen, hook = _record_calls(tm)
    try:
        for i, (B, L, allocs) in enumerate([(3, 250, 1), (3, 100, 1), (3, 200, 1),
                                            (4, 250, 2)]):
            sig = _signals(B=B, L=L, seed=i)
            lengths = np.linspace(L, L // 2, B).astype(np.int32) if with_lengths else None
            got = caller(sig, lengths)
            want = Basecaller(tm, **kw)(sig, lengths)
            (x, logits), (_, fresh_logits) = seen[-2:]
            Lp = -(-L // 128) * 128
            assert x.shape == (B, Lp, LEVELS)
            assert torch.equal(x[:, :L], torch.from_numpy(sig))
            assert not x[:, L:].any()
            assert not caller._stage[:B * Lp * LEVELS].view(B, Lp, LEVELS)[:, L:].any()
            assert torch.equal(logits, fresh_logits)
            assert got == want
            assert (caller.staged_calls, caller.staging_allocs) == (i + 1, allocs)
    finally:
        hook.remove()


def test_basecaller_has_no_silent_cpu_default(pair):
    _, _, tm = pair
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Basecaller(tm)

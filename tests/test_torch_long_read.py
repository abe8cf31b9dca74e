"""Long-read serving in the port (inference.py) against the JAX package on
the CPU: the chunk grid, the default margin, chunked_logits(_batch) on
RawCTCNet and a causal WaveNet, basecall_long (both branches),
basecall_long_batch and from_checkpoint. JAX params cross over through the
bridge; signals are made from a seed.

Tolerances: stitched logits within rtol 1e-4, atol 1e-5 of JAX's and of the
port's own monolithic forward (the model tests' tolerance: the same sums in
another order); the grid and the margin are equal; decoded strings are
equal and beam scores within 1e-3 (the heads are shaped away from the
near-ties of an untrained eye-init net, as JAX's own long-read tests do)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu import inference as jinference
from wavenet_speech_tpu.models import RawCTCNet as JRawCTCNet
from wavenet_speech_tpu.models import WaveNet as JWaveNet
from wavenet_speech_tpu_torch import bridge, inference
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.inference import (Basecaller, _chunk_grid, _default_margin,
                                                chunked_logits, chunked_logits_batch)
from wavenet_speech_tpu_torch.models import RawCTCNet, WaveNet

TOL = dict(rtol=1e-4, atol=1e-5)
SCORE_ATOL = 1e-3


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def rawctc(F=12, seed=0, shaped=False, dils=(1, 2, 4), kernel=3):
    """A JAX RawCTCNet, its params and the port's copy. shaped: the head
    biased and scaled as tests/test_streaming_beam.py does, away from ties."""
    layers = tuple((F, F, kernel, d) for d in dils)
    jnet = JRawCTCNet(F, 3, 5, layers, F, positions=False, softmax=False, causal=False)
    params = jnet.init(jax.random.PRNGKey(seed))
    if shaped:
        params["out2"]["b"] = params["out2"]["b"] + jnp.asarray([0.6, 0.9, -0.3, 0.1, -0.7])
        params["out2"]["w"] = params["out2"]["w"] * 3.0
    tnet = RawCTCNet(F, 3, 5, layers, F, softmax=False, device="cpu")
    tnet.load_state_dict(bridge.raw_ctcnet_from_jax(_np_tree(params)))
    return jnet, params, tnet


def _raw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class _Extended:
    """A stand-in model for the grid: output_length(L) = L + extra."""

    def __init__(self, extra):
        self.extra = extra

    def output_length(self, L):
        return L + self.extra


GRID = [(300, 96, 14), (257, 100, 14), (1000, 128, 0), (1000, 128, 63), (129, 128, 10),
        (130, 128, 60), (5000, 777, 300), (16384 * 7 + 5, 16384, 312),
        (100000, 16384, 312), (200, 64, 1), (65, 64, 31)]


def _check_tiling(grid, L, c, extra):
    """The kept slices tile [0, L + extra) in order; the last chunk is
    right-aligned. Returns how many interior slices the next chunk's kept
    start cut short, and how many chunks keep nothing."""
    starts, bounds, ext = grid
    assert ext == extra and starts[-1] == L - c
    pos = cut = empty = 0
    for i, (s, (lo, hi)) in enumerate(zip(starts, bounds)):
        assert s + lo == pos and hi >= lo
        pos = s + hi
        cut += i < len(starts) - 1 and hi < c + extra
        empty += hi == lo
    assert pos == L + extra
    return cut, empty


@pytest.mark.parametrize("extra", [0, 2, 4])
def test_chunk_grid_matches_jax(extra):
    """Starts, kept slices and extension equal JAX's _chunk_grid, at the
    serving sizes (16384-sample chunks, margin 312) and over a sweep of
    small ones (every margin, every L < 5 chunk_len). Every grid tiles the
    logits with its last chunk right-aligned. The sweep finds no fully
    shadowed chunk: JAX's guard for one (hi = max(hi, lo)) never fires."""
    model = _Extended(extra)
    cases = GRID + [(L, c, m) for c in range(2, 40, 3) for m in range((c + 1) // 2)
                    for L in range(c + 1, 5 * c)]
    cut = empty = 0
    for (L, c, m) in cases:
        got = _chunk_grid(model, L, c, m)
        assert got == jinference._chunk_grid(model, L, c, m), (L, c, m)
        n_cut, n_empty = _check_tiling(got, L, c, extra)
        cut, empty = cut + n_cut, empty + n_empty
    assert cut > 0 and empty == 0


def test_default_margin_matches_jax():
    jnet, _, tnet = rawctc()
    assert _default_margin(tnet) == jinference._default_margin(jnet) == 2 + 2 * (1 + 2 + 4)
    layers = ((8, 8, 2, 1), (8, 8, 2, 4))
    jw, tw = JWaveNet(8, 3, layers, 8), WaveNet(8, 3, layers, 8, device="cpu")
    assert _default_margin(tw) == jinference._default_margin(jw) == 2 + 1 + 4
    cfg = {"model": {"raw": {"num_features": 4, "out_dim": 4, "num_dilation_blocks": 5,
                             "dilations": [1, 2, 4, 8, 16]}}}
    m = Model("raw-ctcnet", cfg, device="cpu")
    assert _default_margin(m) == _default_margin(m.model_ctc) == 312  # gauss_quality's
    # a wavenet-ctc pair: the entry conv, WaveNet's blocks, the classifier's
    pair = Model("wavenet-ctc", {"model": {"base": {"signal_dim": 4, "dilations": [1, 2]},
                                           "classifier": {"dilations": [1, 2]}}}, device="cpu")
    assert _default_margin(pair) == 1 + (1 + 2) + 1 + (1 + 2)


@pytest.mark.parametrize("L,chunk_len", [(300, 96), (257, 100), (96, 200)])
def test_chunked_logits_rawctcnet(L, chunk_len):
    jnet, params, tnet = rawctc()
    sig = _raw((L, 1), 1)
    got = chunked_logits(tnet, sig, chunk_len=chunk_len, chunk_batch=3)
    want = np.asarray(jinference.chunked_logits(jnet, params, jnp.asarray(sig),
                                                chunk_len=chunk_len, chunk_batch=3))
    with torch.no_grad():
        full = tnet(torch.from_numpy(sig)[None])[0].numpy()
    assert got.shape == want.shape == full.shape == (L + 2, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), full, **TOL)


def test_chunked_logits_causal_wavenet():
    """chunked_logits(model.model_base, ...) of a wavenet-ctc pair: the
    causal WaveNet (its blocks on the fused block's plain version)."""
    C = 8
    cfg = {"model": {"base": {"signal_dim": C, "entry_kwidth": 2, "kernel": 2,
                              "dilations": [1, 4]}}}
    jnet = JWaveNet(C, 2, ((C, C, 2, 1), (C, C, 2, 4)), C, softmax=False)
    params = jnet.init(jax.random.PRNGKey(2))
    model = Model("wavenet-ctc", cfg, device="cpu")
    model.model_base.load_state_dict(bridge.wavenet_from_jax(_np_tree(params)))
    sig = np.eye(C, dtype=np.float32)[np.random.default_rng(3).integers(0, C, size=160)]
    got = chunked_logits(model.model_base, sig, chunk_len=64, chunk_batch=2)
    want = jinference.chunked_logits(jnet, params, jnp.asarray(sig), chunk_len=64,
                                     chunk_batch=2)
    with torch.no_grad():
        full = model.model_base(torch.from_numpy(sig)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("B,L,chunk_len", [(3, 300, 96), (2, 257, 100), (4, 96, 200)])
def test_chunked_logits_batch(B, L, chunk_len):
    """Against JAX's, the monolithic forward and the per-read
    chunked_logits (the same grid; the forwards group the chunks otherwise,
    so their sums may differ in order: TOL)."""
    jnet, params, tnet = rawctc()
    sigs = _raw((B, L, 1), 7)
    got = chunked_logits_batch(tnet, sigs, chunk_len=chunk_len, chunk_batch=3)
    want = jinference.chunked_logits_batch(jnet, params, sigs, chunk_len=chunk_len,
                                           chunk_batch=3)
    with torch.no_grad():
        full = tnet(torch.from_numpy(sigs)).numpy()
    assert got.shape == want.shape == full.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), full, **TOL)
    for b in range(B):
        per_read = chunked_logits(tnet, sigs[b], chunk_len=chunk_len, chunk_batch=3)
        np.testing.assert_allclose(got[b].numpy(), per_read.numpy(), **TOL)


def test_margin_guards():
    _, _, tnet = rawctc()
    m = _default_margin(tnet)
    sig = np.zeros((64, 1), np.float32)
    for fn in (chunked_logits, chunked_logits_batch):
        with pytest.raises(ValueError, match="2\\*margin"):
            fn(tnet, sig if fn is chunked_logits else sig[None], chunk_len=2 * m)
    with pytest.raises(ValueError, match="2\\*margin"):
        chunked_logits(tnet, sig, chunk_len=40, margin=20)


def test_pooled_wavenet_ctc_is_refused_before_any_forward(monkeypatch):
    """A pooled classifier emits L // pool frames; the grid counts samples
    (JAX asserts after the forwards, inference.py:252). The port raises
    before the first forward, and a read that fits one chunk still runs."""
    cfg = {"model": {"base": {"signal_dim": 4, "dilations": [1, 2]},
                     "classifier": {"dilations": [1], "downsample": 4}}}
    model = Model("wavenet-ctc", cfg, device="cpu").init(0)
    sig = np.eye(4, dtype=np.float32)[np.random.default_rng(0).integers(0, 4, size=(2, 300))]
    calls = []
    monkeypatch.setattr(model, "forward", lambda x: calls.append(x) or torch.zeros(1))
    for fn, x in ((chunked_logits, sig[0]), (chunked_logits_batch, sig)):
        with pytest.raises(ValueError, match="pool"):
            fn(model, x, chunk_len=64)
    assert calls == []
    caller = Basecaller(model, device="cpu")
    with pytest.raises(ValueError, match="pool"):
        caller.basecall_long_batch(sig, chunk_len=64)
    assert calls == []
    monkeypatch.undo()
    assert chunked_logits(model, sig[0], chunk_len=512).shape == (75, 5)


def test_basecall_long_monolithic_branch_matches_jax():
    """T <= 8192: one monolithic beam over the chunked logits, capped by
    max_label_len."""
    jnet, params, tnet = rawctc(seed=4)
    sig = _raw((400, 1), 5)
    for W, S in ((4, 64), (3, None)):
        kw = dict(beam_width=W, max_label_len=S)
        seq, score = Basecaller(tnet, device="cpu", **kw).basecall_long(
            sig, chunk_len=128, chunk_batch=2)
        jseq, jscore = jinference.Basecaller(model=jnet, params=params, **kw).basecall_long(
            sig, chunk_len=128, chunk_batch=2)
        assert seq == jseq and abs(score - jscore) < SCORE_ATOL
    seq, score = Basecaller(tnet, beam_width=0, device="cpu").basecall_long(
        sig, chunk_len=128)
    jseq, _ = jinference.Basecaller(model=jnet, params=params, beam_width=0).basecall_long(
        sig, chunk_len=128)
    assert seq == jseq and score == 0.0


def test_basecall_long_streaming_branch_matches_jax():
    """T > max(2 beam_chunk_frames, 8192): the streamed decode, equal to
    JAX's (9 chunks of 1024 frames, the last one padded)."""
    jnet, params, tnet = rawctc(F=4, seed=0, shaped=True, dils=(1, 2))
    sig = _raw((8300, 1), 5)
    kw = dict(chunk_len=4096, beam_chunk_frames=1024, label_window=2048)
    seq, score = Basecaller(tnet, beam_width=3, device="cpu").basecall_long(sig, **kw)
    jseq, jscore = jinference.Basecaller(model=jnet, params=params,
                                         beam_width=3).basecall_long(sig, **kw)
    assert len(seq) > 100 and seq == jseq and abs(score - jscore) < SCORE_ATOL


def test_basecall_long_batch_matches_jax():
    jnet, params, tnet = rawctc(seed=4, shaped=True)
    sigs = _raw((3, 700, 1), 11)
    kw = dict(chunk_len=256, beam_chunk_frames=128, label_window=256)
    caller = Basecaller(tnet, beam_width=4, device="cpu")
    seqs, scores = caller.basecall_long_batch(sigs, **kw)
    jseqs, jscores = jinference.Basecaller(model=jnet, params=params,
                                           beam_width=4).basecall_long_batch(sigs, **kw)
    assert seqs == jseqs and all(len(s) > 20 for s in seqs)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=SCORE_ATOL)
    assert caller.saturated_chunks == 0
    # greedy
    g = Basecaller(tnet, beam_width=0, device="cpu").basecall_long_batch(sigs, chunk_len=256)
    jg = jinference.Basecaller(model=jnet, params=params, beam_width=0).basecall_long_batch(
        sigs, chunk_len=256)
    assert g[0] == jg[0] and g[1] == [0.0] * 3


def test_from_checkpoint_round_trip(tmp_path):
    cfg = {"model": {"raw": {"num_features": 8, "out_dim": 8, "num_dilation_blocks": 2,
                             "dilations": [1, 2]}}}
    src = Model("raw-ctcnet", cfg, device="cpu").init(1)
    path = str(tmp_path / "params.pt")
    src.save(path)
    fresh = Model("raw-ctcnet", cfg, device="cpu").init(2)
    caller = Basecaller.from_checkpoint(fresh, path, beam_width=3, device="cpu",
                                        logit_length_fn=fresh.output_length)
    assert caller.model is fresh and caller.beam_width == 3
    for (na, pa), (nb, pb) in zip(src.state_dict().items(), fresh.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    sigs = _raw((2, 200, 1), 3)
    assert caller(sigs) == Basecaller(src, beam_width=3, device="cpu",
                                      logit_length_fn=src.output_length)(sigs)
    # a bare module: its state dict is the params tree
    _, _, tnet = rawctc()
    torch.save({k: v.detach().clone() for k, v in tnet.state_dict().items()},
               str(tmp_path / "net.pt"))
    other = RawCTCNet(12, 3, 5, tnet.layers, 12, softmax=False, device="cpu")
    Basecaller.from_checkpoint(other, str(tmp_path / "net.pt"), beam_width=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(other.state_dict().values(),
                                                  tnet.state_dict().values()))
    with pytest.raises(ValueError, match="checkpoint"):
        Basecaller.from_checkpoint(Model("raw-ctcnet", {"model": {"raw": {
            "num_features": 4, "out_dim": 4, "num_dilation_blocks": 1, "dilations": [1]}}},
            device="cpu"), path, device="cpu")


def test_long_entry_points_need_a_device():
    _, _, tnet = rawctc()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Basecaller(tnet)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Basecaller.from_checkpoint(tnet, "unused")

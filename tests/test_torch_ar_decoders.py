"""The port's autoregressive model family against the JAX package: the
ByteNet blocks, ByteNetDecoder, the LSTM cells and RNNByteNetDecoder,
AttnConvolutionalDecoder, ops/fns and ops/linear_conv, with the JAX params
carried over by ``bridge.decoder_from_jax``.

Tolerance: |port - JAX| <= rtol |JAX| + atol max(1, max|JAX|), rtol 1e-4,
atol 1e-5 on every output (float32 sums in another order over a few
layers, so the error scales with the tensor's size); the single ops at
rtol 1e-5, atol 1e-6. Free-running decodes feed back their own argmax, so
a near-tie between the port and JAX flips a label and everything after
it. They are held by the margin rule: the step logits agree under teacher
forcing (the port's steps fed JAX's emitted labels), and where the
free-running labels differ, the first difference falls on a step whose
top-2 margin in JAX's logits is below twice the logits' tolerance there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.models import blocks as jblocks
from wavenet_speech_tpu.models.bytenet_decoder import ByteNetDecoder as JByteNet
from wavenet_speech_tpu.models.conv_decoder import AttnConvolutionalDecoder as JAttn
from wavenet_speech_tpu.models.conv_decoder import glu as jglu
from wavenet_speech_tpu.models.rnn_decoder import RNNByteNetDecoder as JRNN
from wavenet_speech_tpu.models.rnn_decoder import StackedLSTMCell as JStacked
from wavenet_speech_tpu.models.rnn_decoder import lstm_cell as jlstm_cell
from wavenet_speech_tpu.nn import initializers as jinit
from wavenet_speech_tpu.ops import fns as jfns
from wavenet_speech_tpu.ops import linear_conv as jlinear
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.models import (AttnConvolutionalDecoder, ByteNetDecoder,
                                             MultiplicativeUnit, ResidualMUBlock,
                                             ResidualReLUBlock, RNNByteNetDecoder,
                                             StackedLSTMCell)
from wavenet_speech_tpu_torch.models.conv_decoder import glu
from wavenet_speech_tpu_torch.models.rnn_decoder import lstm_cell
from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.ops import fns
from wavenet_speech_tpu_torch.ops.conv import causal_conv1d
from wavenet_speech_tpu_torch.ops.linear_conv import ker_ixs, linear_conv_step

TOL = dict(rtol=1e-4, atol=1e-5)
OP_TOL = dict(rtol=1e-5, atol=1e-6)


def assert_close(got, want, tol=TOL):
    """|got - want| <= rtol |want| + atol max(1, max|want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(jmod, seed):
    """JAX params of jmod from PRNGKey(seed)."""
    return jmod.init(jax.random.PRNGKey(seed))


def _port(module, jparams):
    """module.eval() holding the JAX params (bridge.decoder_from_jax)."""
    module.load_state_dict(bridge.decoder_from_jax(_np(jparams)))
    return module.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def check_margin_rule(jax_logits, jax_labels, port_labels, tol=TOL):
    """Where the free-running labels differ, the first difference of each
    row falls on a step whose top-2 margin in JAX's logits is below twice
    the tolerance of assert_close at its top-2 values. Returns the rows
    that differ."""
    jax_logits = np.asarray(jax_logits)
    jax_labels, port_labels = np.asarray(jax_labels), np.asarray(port_labels)
    scale = max(1.0, float(np.abs(jax_logits).max()))
    rows = np.flatnonzero((jax_labels != port_labels).any(axis=1))
    for b in rows:
        t = int(np.flatnonzero(jax_labels[b] != port_labels[b])[0])
        top2 = np.sort(jax_logits[b, t])[-2:]
        bound = 2 * (tol["rtol"] * np.abs(top2).max() + tol["atol"] * scale)
        assert top2[1] - top2[0] < bound, (b, t, top2, bound)
    return rows


# ---- initializers, ops ----------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 64, 256), (256, 192), (4, 8, 16, 96)])
def test_kaiming_normal_shape_and_variance(shape):
    """N(0, sqrt(2 / fan_in)), fan_in as JAX's: the sample std within 3% of
    it (>= 49,152 draws: the std's standard error is 0.3%); JAX's sample
    std at the same shape within 3% too."""
    w = init.kaiming_normal(shape, torch.Generator().manual_seed(0))
    fan_in = {3: shape[0] * shape[1], 2: shape[0]}.get(len(shape), int(np.prod(shape[:-1])))
    want = np.sqrt(2.0 / fan_in)
    assert tuple(w.shape) == shape and w.dtype == torch.float32
    assert abs(float(w.mean())) < 0.05 * want
    assert float(w.std()) == pytest.approx(want, rel=0.03)
    jw = np.asarray(jinit.kaiming_normal(jax.random.PRNGKey(0), shape))
    assert float(jw.std()) == pytest.approx(want, rel=0.03)


@pytest.mark.parametrize("axis", [-1, 1])
def test_one_hot_encoding_matches_jax(axis, rng):
    labels = rng.integers(0, 6, size=(3, 11)).astype(np.int32)
    got = fns.one_hot_encoding(_t(labels), 6, axis=axis)
    want = np.asarray(jfns.one_hot_encoding(jnp.asarray(labels), 6, axis=axis))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("depth,stacks,k", [(9, 3, 2), (5, 1, 3), (0, 2, 2)])
def test_compute_receptive_field_matches_jax(depth, stacks, k):
    assert fns.compute_receptive_field(depth, stacks, k) == \
        jfns.compute_receptive_field(depth, stacks, k)


@pytest.mark.parametrize("k,d", [(2, 1), (3, 2), (2, 4), (5, 3)])
def test_linear_conv_step_matches_jax_and_the_conv(k, d, rng):
    rf = k + (d - 1) * (k - 1)
    frame = rng.standard_normal((2, rf, 4)).astype(np.float32)
    w = rng.standard_normal((k, 4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    np.testing.assert_array_equal(ker_ixs(d, k), jlinear.ker_ixs(d, k))
    got = linear_conv_step(_t(frame), _t(w), _t(b), dilation=d)
    want = np.asarray(jlinear.linear_conv_step(jnp.asarray(frame), jnp.asarray(w),
                                               jnp.asarray(b), dilation=d))
    assert_close(got.numpy(), want, OP_TOL)
    full = causal_conv1d(_t(frame), _t(w), _t(b), dilation=d)[:, -1]
    assert_close(got.numpy(), full.numpy(), OP_TOL)
    with pytest.raises(ValueError):
        linear_conv_step(_t(frame[:, 1:]), _t(w), _t(b), dilation=d)


# ---- ByteNet blocks and decoder -------------------------------------------

@pytest.mark.parametrize("cls,args", [
    (MultiplicativeUnit, (6, 3, 2)), (MultiplicativeUnit, (6, 1, 1)),
    (ResidualMUBlock, (8, 3, 2)), (ResidualReLUBlock, (8, 2, 4))],
    ids=["mu-k3-d2", "mu-k1", "mu-block", "relu-block"])
def test_bytenet_blocks_match_jax(cls, args, rng):
    jmod = getattr(jblocks, cls.__name__)(*args)
    params = _init(jmod, 1)
    tmod = _port(cls(*args), params)
    x = rng.standard_normal((2, 17, args[0])).astype(np.float32)
    with torch.no_grad():
        got = tmod(_t(x))
    assert_close(got.numpy(), np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x))))
    assert tmod.receptive_field == jmod.receptive_field
    # the port's own init: JAX's distributions (kaiming-normal weights,
    # noisy-zero biases) at JAX's shapes
    tmod.reset_parameters(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tmod.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in bridge.decoder_from_jax(_np(params)).items()}


def _bytenet(block, max_t=12, ch=4):
    kw = dict(num_labels=7, encoding_dim=6, channels=ch, output_dim=8,
              layers=((3, 1), (3, 2)), block=block, max_timesteps=max_t)
    return JByteNet(**kw), ByteNetDecoder(**kw)


def _bytenet_replay(dec, enc, labels):
    """The port's generate loop with JAX's labels fed back (teacher
    forcing): its step logits (B, T, num_labels)."""
    B, L_enc, E = enc.shape
    rf = dec.receptive_field
    buf = torch.full((B, rf), dec.pad, dtype=torch.long)
    buf[:, -1] = dec.start
    enc_pad = torch.nn.functional.pad(enc, (0, 0, rf - 1, 0))
    out = []
    for k in range(labels.shape[1]):
        window = enc_pad[:, k:k + rf] if k < L_enc else torch.full((B, rf, E), float(dec.pad))
        out.append(dec.linear(buf, window))
        buf = torch.cat([buf[:, 1:], labels[:, k:k + 1]], dim=1)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("block", ["mult", "relu"])
def test_bytenet_apply_and_linear_match_jax(block, rng):
    jdec, tdec = _bytenet(block)
    params = _init(jdec, 0)
    tdec = _port(tdec, params)
    assert tdec.receptive_field == jdec.receptive_field
    rf = jdec.receptive_field
    labels = rng.integers(0, 7, size=(2, 2 * rf)).astype(np.int32)
    enc = rng.standard_normal((2, 2 * rf, 6)).astype(np.float32)
    with torch.no_grad():
        full = tdec(_t(labels), _t(enc))
        lin = tdec.linear(_t(labels[:, -rf:]), _t(enc[:, -rf:]))
    jfull = np.asarray(jax.jit(jdec.apply)(params, jnp.asarray(labels), jnp.asarray(enc)))
    assert_close(full.numpy(), jfull)
    assert_close(lin.numpy(), np.asarray(
        jax.jit(jdec.linear)(params, jnp.asarray(labels[:, -rf:]),
                             jnp.asarray(enc[:, -rf:]))))


@pytest.mark.parametrize("block,L_enc", [("mult", 8), ("relu", 15)])
def test_bytenet_generate_matches_jax(block, L_enc, rng):
    """max_timesteps 12: with L_enc 8 the last 4 steps read the pad-filled
    window (the reference's quirk, kept); with 15 none does."""
    jdec, tdec = _bytenet(block)
    params = _init(jdec, 1)
    tdec = _port(tdec, params)
    enc = rng.standard_normal((3, L_enc, 6)).astype(np.float32)
    jlogits, jlengths = (np.asarray(a) for a in jax.jit(jdec.generate)(params,
                                                                       jnp.asarray(enc)))
    logits, lengths = tdec.generate(_t(enc))
    assert logits.shape == jlogits.shape == (3, 12, 7) and lengths.dtype == torch.int32
    jlabels = jlogits.argmax(-1)
    with torch.no_grad():
        forced = _bytenet_replay(tdec, _t(enc), torch.from_numpy(jlabels).long())
    assert_close(forced.numpy(), jlogits)
    if not len(check_margin_rule(jlogits, jlabels, logits.argmax(-1).numpy())):
        assert_close(logits.numpy(), jlogits)
        np.testing.assert_array_equal(lengths.numpy(), jlengths)


def test_bytenet_stop_bookkeeping():
    """<STOP> forced from the first step: lengths stay 0 (the stop step is
    not counted), as JAX's; forced at a later step through the bias of a
    label that the decoder then feeds back."""
    jdec, tdec = _bytenet("mult", max_t=6)
    params = _init(jdec, 2)
    params["out2"]["b"] = params["out2"]["b"].at[jdec.stop].set(100.0)
    tdec = _port(tdec, params)
    enc = np.zeros((3, 5, 6), np.float32)
    _, lengths = tdec.generate(_t(enc))
    np.testing.assert_array_equal(lengths.numpy(), 0)
    np.testing.assert_array_equal(lengths.numpy(),
                                  np.asarray(jdec.generate(params, jnp.asarray(enc))[1]))
    with torch.no_grad():
        tdec.out2.b[jdec.stop] = -100.0
    logits, lengths = tdec.generate(_t(enc))
    labels = logits.argmax(-1)
    assert (labels != jdec.stop).all()
    np.testing.assert_array_equal(lengths.numpy(), 6)


# ---- LSTM cells and the RNN decoder ---------------------------------------

def test_lstm_cell_matches_jax_and_torch(rng):
    H, B = 16, 3
    p = {k: (rng.standard_normal(s).astype(np.float32) * 0.1)
         for k, s in (("w_ih", (4 * H, H)), ("w_hh", (4 * H, H)), ("b_ih", 4 * H),
                      ("b_hh", 4 * H))}
    x, h, c = (rng.standard_normal((B, H)).astype(np.float32) for _ in range(3))
    got = lstm_cell({k: _t(v) for k, v in p.items()}, _t(x), _t(h), _t(c))
    want = jlstm_cell({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                      jnp.asarray(h), jnp.asarray(c))
    cell = torch.nn.LSTMCell(H, H)
    with torch.no_grad():
        for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"),
                          ("bias_hh", "b_hh")):
            getattr(cell, name).copy_(_t(p[key]))
        ref = cell(_t(x), (_t(h), _t(c)))
    for g, w, r in zip(got, want, ref):
        assert_close(g.numpy(), np.asarray(w), OP_TOL)
        assert_close(g.numpy(), r.numpy(), OP_TOL)


def test_stacked_lstm_matches_jax(rng):
    jstack = JStacked(8, 3)
    params = _init(jstack, 4)
    tstack = _port(StackedLSTMCell(8, 3), params)
    x = rng.standard_normal((2, 8)).astype(np.float32)
    hs = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(3)]
    cs = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(3)]
    with torch.no_grad():
        out, h1s, c1s = tstack(_t(x), [_t(a) for a in hs], [_t(a) for a in cs])
    jout, jh, jc = jax.jit(jstack.apply)(params, jnp.asarray(x), [jnp.asarray(a) for a in hs],
                                [jnp.asarray(a) for a in cs])
    for g, w in zip([out, *h1s, *c1s], [jout, *jh, *jc]):
        assert_close(g.numpy(), np.asarray(w))


def _rnn(max_t=10):
    kw = dict(num_labels=7, encoding_dim=6, hidden_dim=8, out_dim=8, num_layers=2,
              max_timesteps=max_t)
    return JRNN(**kw), RNNByteNetDecoder(**kw)


def _rnn_replay(dec, enc, labels, hs, cs):
    """The port's unfold with JAX's labels fed back: step logits."""
    B, L, E = enc.shape
    label = torch.full((B,), dec.start, dtype=torch.long)
    out = []
    for t in range(labels.shape[1]):
        o, hs, cs = dec(label, hs, cs, enc[:, t] if t < L else torch.zeros((B, E)))
        out.append(o)
        label = labels[:, t]
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("L", [6, 12])
def test_rnn_decoder_unfold_matches_jax(L, rng):
    jdec, tdec = _rnn()
    params = _init(jdec, 3)
    tdec = _port(tdec, params)
    enc = rng.standard_normal((2, L, 6)).astype(np.float32)
    jlogits, jlengths = (np.asarray(a) for a in jax.jit(jdec.unfold)(params,
                                                                     jnp.asarray(enc)))
    logits, lengths = tdec.unfold(_t(enc))
    assert logits.shape == jlogits.shape == (2, 10, 7)
    jlabels = jlogits.argmax(-1)
    zeros = [torch.zeros((2, 8)) for _ in range(2)]
    with torch.no_grad():
        forced = _rnn_replay(tdec, _t(enc), torch.from_numpy(jlabels).long(), zeros, zeros)
    assert_close(forced.numpy(), jlogits)
    if not len(check_margin_rule(jlogits, jlabels, logits.argmax(-1).numpy())):
        assert_close(logits.numpy(), jlogits)
        np.testing.assert_array_equal(lengths.numpy(), jlengths)
    # one step (JAX apply) on given states
    hs = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(2)]
    x0 = np.array([5, 2], np.int32)
    with torch.no_grad():
        out, _, _ = tdec(_t(x0), [_t(a) for a in hs], [_t(a) for a in hs], _t(enc[:, 0]))
    jout, _, _ = jax.jit(jdec.apply)(params, jnp.asarray(x0), [jnp.asarray(a) for a in hs],
                            [jnp.asarray(a) for a in hs], jnp.asarray(enc[:, 0]))
    assert_close(out.numpy(), np.asarray(jout))


def test_rnn_unfold_with_a_generator():
    """The initial states are 0.001 * N(0, 1) from the generator, each
    layer's h then each layer's c: a fixed seed reproduces the decode, which
    equals the replay from states drawn by hand from the same seed."""
    jdec, tdec = _rnn()
    tdec = _port(tdec, _init(jdec, 5))
    enc = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 6, 6))
                           .astype(np.float32))
    a = tdec.unfold(enc, generator=torch.Generator().manual_seed(7))
    b = tdec.unfold(enc, generator=torch.Generator().manual_seed(7))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    g = torch.Generator().manual_seed(7)
    states = [0.001 * torch.randn((2, 8), generator=g) for _ in range(4)]
    with torch.no_grad():
        forced = _rnn_replay(tdec, enc, a[0].argmax(-1), states[:2], states[2:])
    assert_close(a[0].numpy(), forced.numpy(), OP_TOL)


# ---- the attention decoder ------------------------------------------------

def test_glu_matches_jax(rng):
    x, y = (rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2))
    assert_close(glu(_t(x), _t(y)).numpy(), np.asarray(jglu(jnp.asarray(x), jnp.asarray(y))),
                 OP_TOL)


def test_attn_conv_decoder_matches_jax(rng):
    """With the optional LayerNorm, the superset of the layer's paths."""
    layers = ((3, 8, 8), (2, 8, 6))
    kw = dict(num_labels=7, embed_dim=8, layers=layers, encoding_dim=5, max_time=9, norm=True)
    jdec = JAttn(**kw)
    params = jax.jit(jdec.init)(jax.random.PRNGKey(6))   # one compile, not one an array
    tdec = _port(AttnConvolutionalDecoder(**kw), params)
    # a positive encoding keeps the sum-normalized attention's denominators
    # away from 0
    enc = rng.uniform(0.5, 1.5, size=(2, 11, 5)).astype(np.float32)
    targets = rng.integers(0, 7, size=(2, 9)).astype(np.int32)
    with torch.no_grad():
        got = tdec(_t(enc), _t(targets))
    want = np.asarray(jax.jit(jdec.apply)(params, jnp.asarray(enc), jnp.asarray(targets)))
    assert got.shape == (2, 9, 7)
    assert_close(got.numpy(), want)
    with pytest.raises(ValueError):
        tdec(_t(enc), _t(targets[:, :5]))

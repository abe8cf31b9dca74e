"""The pretraining entry points (training/pretrain.py), RawSignalGenerator,
Batch.flat_labels and ctc_loss_flat against the JAX package.

pretrain_ctc inits its encoder inside (JAX: PRNGKey(0)), so the port's run
starts from JAX's initial params through a patch of the port's init hook
(``pretrain._init_params``); pretrain_ctc itself takes JAX's arguments
only. Tolerance: the first loss within rtol 1e-4, atol 1e-6 of JAX's, as
the CTC step's tests (tests/test_torch_ctc_step.py). The next ones are
held to a float64 run of JAX's step: the encoder reads raw pico-amps
(~100) and Adamax's first updates are sign-like, so float32 rounding of
the gradients (JAX's own 5.7e-5 from float64 in relative norm, the port's
8.5e-5) flips the sign of small elements' updates, and JAX's float32 run
is itself 2.5e-3 and 4.1e-3 from float64 at losses 2 and 3. Each of the
port's first 3 losses lies within SENS_FACTOR x JAX float32's distance
from float64, plus the tolerance above. ctc_loss_flat within rtol 1e-5,
atol 1e-5, as the CTC's (tests/test_torch_ctc.py). The generators and the
label helpers are numpy and must agree bit for bit."""
import dataclasses

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401  (a fixture)
from wavenet_speech_tpu.data import RawGaussianModelLoader as JRawGaussian
from wavenet_speech_tpu.data.common import Batch as JBatch
from wavenet_speech_tpu.data.raw_signal import RawSignalGenerator as JRawSignal
from wavenet_speech_tpu.ops.ctc import ctc_loss_flat as j_ctc_loss_flat
from wavenet_speech_tpu.training import TrainState as JTrainState
from wavenet_speech_tpu.training import build_optimizer as j_build_optimizer
from wavenet_speech_tpu.training import pretrain as jpretrain
from wavenet_speech_tpu.training.trainer import make_ctc_train_step as j_make_ctc_train_step
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.data import Batch, RawGaussianModelLoader, RawSignalGenerator
from wavenet_speech_tpu_torch.ops.ctc import ctc_loss_flat
from wavenet_speech_tpu_torch.training import pretrain

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
SENS_FACTOR = 4.0
CTC_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_to_concat_to_stack_match_jax(rng):
    lengths = np.array([3, 5, 0, 2], np.int64)
    stacked = np.zeros((4, 5), np.int64)
    for k, n in enumerate(lengths):
        stacked[k, :n] = rng.integers(1, 5, size=n)
    flat = pretrain.to_concat(stacked, lengths)
    np.testing.assert_array_equal(flat, jpretrain.to_concat(stacked, lengths))
    back = pretrain.to_stack(flat, lengths)
    np.testing.assert_array_equal(back, jpretrain.to_stack(flat, lengths))
    np.testing.assert_array_equal(back, stacked)
    assert pretrain.to_concat(stacked[:0], lengths[:0]).shape == (0,)
    assert pretrain.to_stack(flat[:0], lengths[:0]).shape == (0, 0)


@pytest.mark.parametrize("which", ["posenc", "encdec", "rnn"])
def test_builders_match_jax_through_the_bridge(which):
    """At scale 1/32 the port's modules hold JAX's params by name and shape
    once bridged (JAX's shapes by jax.eval_shape: nothing is computed)."""
    build = {"posenc": "build_posenc_encoder", "encdec": "build_encdec",
             "rnn": "build_rnn_decoder_pair"}[which]
    kw = {} if which == "posenc" else {"max_time": 10}
    jmods = getattr(jpretrain, build)(scale=1 / 32, remat=False, **kw)
    tmods = getattr(pretrain, build)(scale=1 / 32, remat=False, device="cpu", **kw)
    if which == "posenc":
        jmods, tmods = (jmods,), (tmods,)
        assert tmods[0].positions and tmods[0].num_features == 16
    elif which == "encdec":
        assert (tmods[1].num_labels, tmods[1].stop, tmods[1].max_timesteps) == (7, 6, 10)
        assert tmods[1].receptive_field == jmods[1].receptive_field
    else:
        assert (tmods[1].num_layers, tmods[1].hidden_dim) == (3, 8)
    for jmod, tmod, to_port in zip(jmods, tmods, (bridge.raw_ctcnet_from_jax,
                                                  bridge.decoder_from_jax)):
        shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0))
        zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
        want = {k: tuple(v.shape) for k, v in to_port(zeros).items()}
        assert {k: tuple(v.shape) for k, v in tmod.state_dict().items()} == want
        tmod.load_state_dict(to_port(zeros))


def _fixed_batches():
    """The JAX test's fixed batch (tests/test_pretrain.py), from JAX's
    loader and the port's: equal bit for bit."""
    kw = dict(max_iters=10 ** 9, num_epochs=10 ** 6, epoch_size=100, batch_size=2,
              upsampling=3, lengths=(15, 18), seed=3, pad_to=(18 - 1 - 8) * 3,
              labels_pad_to=17)
    jb, tb = JRawGaussian(**kw).fetch(), RawGaussianModelLoader(**kw).fetch()
    for f in dataclasses.fields(tb):
        np.testing.assert_array_equal(getattr(tb, f.name), getattr(jb, f.name))
    return jb, tb


def _jax_float64_losses(jenc, jparams, jb, steps):
    """JAX's CTC step (Adamax 2e-3, pretrain_ctc's) in float64 from
    jparams on the fixed batch: the yardstick's exact run."""
    with jax.enable_x64(True):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jparams)
        tx = j_build_optimizer("adamax", 2e-3)
        state, step = JTrainState.create(p, tx), j_make_ctc_train_step(jenc, tx, donate=False)
        batch = {"signal": jnp.asarray(jb.signal, jnp.float64), "labels": jb.labels,
                 "label_lengths": jb.label_lengths, "signal_lengths": jb.signal_lengths}
        losses = []
        for _ in range(steps):
            state, m = step(state, batch)
            losses.append(float(m["ctc_loss"]))
    return np.array(losses)


def test_pretrain_ctc_matches_jax_and_loss_falls(monkeypatch, one_thread):
    """From JAX's init (PRNGKey(0)): the first loss equals JAX's, the first
    3 lie within SENS_FACTOR x JAX float32's distance from float64 (module
    docstring); then the JAX test's own property on the port: over 60 steps
    on the fixed batch the loss falls below 0.7x the first, and the
    callback sees step 0 and every 10th."""
    jb, tb = _fixed_batches()
    jenc = jpretrain.build_posenc_encoder(scale=1 / 32, remat=False)
    _, jlosses = jpretrain.pretrain_ctc(jenc, (jb for _ in range(3)), num_steps=3)
    jparams = _np(jenc.init(jax.random.PRNGKey(0)))
    exact = _jax_float64_losses(jenc, jparams, jb, 3)
    monkeypatch.setattr(pretrain, "_init_params",
                        lambda enc: bridge.raw_ctcnet_from_jax(jparams))
    tenc = pretrain.build_posenc_encoder(scale=1 / 32, device="cpu")
    seen = []
    state, losses = pretrain.pretrain_ctc(tenc, (tb for _ in range(60)), num_steps=60,
                                          learning_rate=2e-3,
                                          callback=lambda i, v: seen.append((i, v)))
    np.testing.assert_allclose(losses[0], jlosses[0], **LOSS_TOL)
    bound = SENS_FACTOR * np.abs(np.array(jlosses) - exact) \
        + LOSS_TOL["rtol"] * np.abs(exact) + LOSS_TOL["atol"]
    assert (np.abs(np.array(losses[:3]) - exact) <= bound).all(), (losses[:3], jlosses, exact)
    assert len(losses) == 60 and int(state.step) == 60
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])
    assert [i for i, _ in seen] == list(range(0, 60, 10))
    assert seen[0][1] == pytest.approx(losses[0])


def test_pretrain_ctc_inits_from_its_seed():
    """Without the patch the port draws its own init from INIT_SEED: two
    runs give the same losses."""
    _, tb = _fixed_batches()
    runs = [pretrain.pretrain_ctc(pretrain.build_posenc_encoder(1 / 32, device="cpu"),
                                  (tb for _ in range(2)), num_steps=2)[1] for _ in range(2)]
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))


def _genome(path, rng):
    """A reference genome of 4 contigs, one shorter than the longest read
    (returned whole), in the /<name>/contig layout."""
    with h5py.File(path, "w") as f:
        for name, n in (("chr1", 900), ("chr2", 640), ("plasmid", 90), ("chr3", 2000)):
            f.create_group(name).create_dataset(
                "contig", data=rng.integers(1, 5, size=n).astype(np.int8))


@pytest.mark.parametrize("lengths,pads", [((100, 200), (None, None)),
                                          ("pmf", (1500, 220))])
def test_raw_signal_generator_matches_jax(tmp_path, lengths, pads):
    _genome(tmp_path / "genome.hdf5", np.random.default_rng(1))
    if lengths == "pmf":
        pmf = np.random.default_rng(2).random(200)
        pmf[:50] = 0.0
        np.save(tmp_path / "lengths.npy", pmf)
        lengths = str(tmp_path / "lengths.npy")
    kw = dict(kmer_model=None, reference_hdf=str(tmp_path / "genome.hdf5"),
              read_length_model=lengths, sample_rate=800.0, batch_size=4,
              pad_to=pads[0], labels_pad_to=pads[1], seed=7)
    tgen, jgen = RawSignalGenerator(**kw), JRawSignal(**kw)
    try:
        for _ in range(3):
            tb, jb = next(tgen), next(jgen)
            for f in dataclasses.fields(tb):
                got, want = getattr(tb, f.name), getattr(jb, f.name)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            assert tb.signal.shape[2] == 1 and (tb.label_lengths <= 200).all()
    finally:
        tgen.close()
        jgen.close()


def test_flat_labels_and_ctc_loss_flat_match_jax(rng):
    lens = np.array([4, 0, 6], np.int32)
    labels = np.zeros((3, 7), np.int32)
    for b, n in enumerate(lens):
        labels[b, :n] = rng.integers(1, 5, size=n)
    sig = np.zeros((3, 5, 1), np.float32)
    tb, jb = Batch(sig, labels, lens, lens), JBatch(sig, labels, lens, lens)
    assert tb.flat_labels.dtype == np.int32
    np.testing.assert_array_equal(tb.flat_labels, jb.flat_labels)
    assert Batch(sig[:0], labels[:0], lens[:0], lens[:0]).flat_labels.shape == (0,)
    logits = rng.standard_normal((3, 16, 5)).astype(np.float32)
    logit_lens = np.array([16, 9, 14], np.int32)
    got = ctc_loss_flat(torch.from_numpy(logits), logit_lens, tb.flat_labels, lens)
    want = j_ctc_loss_flat(jnp.asarray(logits), logit_lens, jb.flat_labels, lens)
    np.testing.assert_allclose(float(got), float(want), **CTC_TOL)

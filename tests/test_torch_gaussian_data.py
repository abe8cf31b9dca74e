"""The port's Gaussian r9.4 5-mer generators (data/gaussian_kmer.py) and
facade.Dataset's gauss, raw-gauss and raw-pore datatypes against the JAX
package on the CPU: on a fixed seed the batches are equal bit for bit (the
same numpy calls in the same order), with random upsampling on and off, at
upsampling 1 (where the reference ignores random upsampling), with pad_to,
and on the validation stream (seed + 10**6). Exact equality: no tolerance."""
import filecmp

import numpy as np
import pytest

from wavenet_speech_tpu.data import gaussian_kmer as jgk
from wavenet_speech_tpu.facade import Dataset as JDataset
from wavenet_speech_tpu_torch.data import gaussian_kmer as gk
from wavenet_speech_tpu_torch.facade import Dataset

FIELDS = ("signal", "labels", "label_lengths", "signal_lengths")


def _assert_batches_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_kmer_table_is_the_jax_packages():
    assert filecmp.cmp(gk.DEFAULT_KMER_MODEL, jgk.DEFAULT_KMER_MODEL, shallow=False)
    assert gk.DEFAULT_KMER_MODEL.startswith(gk.__file__.rsplit("/", 1)[0])


@pytest.mark.parametrize("trim", [0, 2])
def test_kmer_ids_and_random_upsample_equal_jax(trim):
    rng = np.random.default_rng(trim)
    seq = rng.integers(1, 5, size=31).astype(np.int32)
    got, want = gk.kmer_ids(seq, trim), jgk.kmer_ids(seq, trim)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 31 - 4 - 2 * trim and got.max() < 4 ** 5
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(gk.random_upsample(got, 4, a), jgk.random_upsample(want, 4, b))


@pytest.mark.parametrize("raw", [False, True], ids=["gauss", "raw-gauss"])
@pytest.mark.parametrize("kw", [dict(upsampling=3), dict(upsampling=4, random_upsample=True),
                                dict(upsampling=1, random_upsample=True),
                                dict(upsampling=2, pad_to=80, labels_pad_to=30)],
                         ids=["fixed", "random", "upsampling1", "pad_to"])
def test_gaussian_loader_batches_equal_jax(raw, kw):
    args = dict(max_iters=3, num_epochs=1, epoch_size=100, batch_size=3, lengths=(14, 25),
                seed=7, **kw)
    if not raw:
        args["num_levels"] = 32
    cls, jcls = ((gk.RawGaussianModelLoader, jgk.RawGaussianModelLoader) if raw else
                 (gk.GaussianModelLoader, jgk.GaussianModelLoader))
    got, want = cls(**args), jcls(**args)
    assert (got.max_signal_length, got.max_label_length, got.signal_channels) == \
        (want.max_signal_length, want.max_label_length, want.signal_channels)
    for _ in range(3):
        g = got.fetch()
        _assert_batches_equal(g, want.fetch())
        assert g.signal.shape[1] <= kw.get("pad_to", got.max_signal_length)
    for ld in (got, want):
        with pytest.raises(StopIteration):
            ld.fetch()


def test_max_signal_length_is_the_jax_bound():
    """(max_length - 1 - 8) k-mers times upsampling (+1 when random): the
    trim of 2 windows at each end takes 8 of a sequence's k-mers."""
    ld = gk.RawGaussianModelLoader(1, 1, 1, upsampling=6, lengths=(80, 90))
    assert (ld.max_signal_length, ld.max_label_length) == (486, 89)
    ld = gk.RawGaussianModelLoader(1, 1, 1, upsampling=6, random_upsample=True, lengths=(80, 90))
    assert ld.max_signal_length == 81 * 7
    assert gk.RawGaussianModelLoader(1, 1, 1, upsampling=0, lengths=(5, 8)).max_signal_length == 0


@pytest.mark.parametrize("datatype", ["gauss", "raw-gauss", "raw-pore"])
@pytest.mark.parametrize("static_shapes", [True, False])
def test_dataset_streams_equal_jax(datatype, static_shapes):
    kw = dict(max_iters=3, num_epochs=2, epoch_size=2, batch_size=2, num_levels=64,
              min_length=20, max_length=30, seed=11, upsampling=3, sample_noise=2.5,
              static_shapes=static_shapes)
    got, want = Dataset(datatype, **kw), JDataset(datatype, **kw)
    assert got.signal_channels == want.signal_channels == (64 if datatype == "gauss" else 1)
    for _ in range(2):
        for stream in ("train", "valid"):
            g = got.fetch(stream)
            _assert_batches_equal(g, want.fetch(stream))
            if static_shapes:
                ld = got.data
                assert g.signal.shape[1] == ld.max_signal_length
                assert g.labels.shape[1] == ld.max_label_length
    _assert_batches_equal(got.fetch("train"), want.fetch("train"))
    for ds in (got, want):
        with pytest.raises(StopIteration):
            ds.fetch("train")
        ds.fetch("valid")


def test_gauss_quality_shapes():
    """configs/gauss_quality.json's data: B=6, signals padded to 486
    samples, labels to 89."""
    ds = Dataset("raw-gauss", batch_size=6, min_length=80, max_length=90, upsampling=6,
                 seed=0)
    b = ds.fetch("train")
    assert b.signal.shape == (6, 486, 1) and b.labels.shape == (6, 89)
    assert b.signal.dtype == np.float32 and np.isfinite(b.signal).all()

"""The port's data path (data/common.py, pore_model.py, prefetch.py,
facade.Dataset) against the JAX package's on the CPU: on fixed seeds the
pore batches are equal bit for bit (the same numpy calls in the same
order), the train and validation streams of Dataset("pore") too, and the
epoch bookkeeping stops at the same fetch."""
import dataclasses

import numpy as np
import pytest
import torch

from wavenet_speech_tpu.data import PoreModelLoader as JPoreModelLoader
from wavenet_speech_tpu.data import common as jcommon
from wavenet_speech_tpu.data.pore_model import centered_window_filter as j_filter
from wavenet_speech_tpu.data.pore_model import triang_window as j_triang
from wavenet_speech_tpu.facade import Dataset as JDataset
from wavenet_speech_tpu_torch.data import common
from wavenet_speech_tpu_torch.data.pore_model import (DEFAULT_CURRENTS, PoreModelLoader,
                                                      centered_window_filter, triang_window)
from wavenet_speech_tpu_torch.data.prefetch import batch_to_device, prefetch_to_device
from wavenet_speech_tpu_torch.facade import Dataset

FIELDS = ("signal", "labels", "label_lengths", "signal_lengths")


def _assert_batches_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("width", [2, 3, 4, 5, 8])
def test_window_helpers_equal_jax(width):
    np.testing.assert_array_equal(triang_window(width), j_triang(width))
    x = np.random.default_rng(width).standard_normal(40)
    np.testing.assert_array_equal(centered_window_filter(x, triang_window(width)),
                                  j_filter(x, j_triang(width)))
    assert DEFAULT_CURRENTS == {1: 51.0, 2: 22.0, 3: 103.0, 4: 115.0}


@pytest.mark.parametrize("kw", [dict(),
                                dict(pad_to=80, labels_pad_to=30),
                                dict(interleave_blanks=True),
                                dict(raw_signal=True, sample_noise=1.5),
                                dict(num_levels=32, pore_width=3, sample_rate=2)],
                         ids=["plain", "pad_to", "interleave_blanks", "raw_signal", "widths"])
def test_pore_loader_batches_equal_jax(kw):
    args = dict(max_iters=4, num_epochs=1, epoch_size=100, batch_size=3, lengths=(10, 20),
                seed=5, **kw)
    got, want = PoreModelLoader(**args), JPoreModelLoader(**args)
    assert (got.max_signal_length, got.max_label_length, got.signal_channels) == \
        (want.max_signal_length, want.max_label_length, want.signal_channels)
    for _ in range(4):
        _assert_batches_equal(got.fetch(), want.fetch())
    for ld in (got, want):
        with pytest.raises(StopIteration):
            ld.fetch()


def test_dataset_pore_streams_equal_jax():
    kw = dict(max_iters=3, num_epochs=2, epoch_size=2, batch_size=2, num_levels=64,
              min_length=12, max_length=20, seed=11, upsampling=3, sample_noise=2.5)
    got, want = Dataset("pore", **kw), JDataset("pore", **kw)
    assert got.signal_channels == want.signal_channels == 64
    shapes = set()
    for _ in range(2):
        for stream in ("train", "valid"):
            g = got.fetch(stream)
            _assert_batches_equal(g, want.fetch(stream))
            shapes.add((stream, g.signal.shape, g.labels.shape))
    assert len(shapes) == 2  # static shapes: one per stream (equal here)
    # the training stream stops at max_iters; the validation stream does not
    _assert_batches_equal(got.fetch("train"), want.fetch("train"))
    for ds in (got, want):
        with pytest.raises(StopIteration):
            ds.fetch("train")
        ds.fetch("valid")


@pytest.mark.parametrize("datatype", ["gauss", "hdf5", "raw-pore", "raw-gauss", "raw-hdf5"])
def test_dataset_other_datatypes_raise(datatype, tmp_path):
    """gauss, raw-pore, raw-gauss and hdf5 are ported: their batches equal
    JAX's (hdf5 on a file of tools/make_synthetic_reads.py, one producer a
    split, so the queues' order is the producers'); raw-hdf5 raises, as in
    JAX."""
    if datatype == "raw-hdf5":
        for cls in (Dataset, JDataset):
            with pytest.raises(NotImplementedError, match="unsupported"):
                cls(datatype, seed=0)
        return
    kw = dict(batch_size=2, min_length=20, max_length=26, num_levels=16, seed=3)
    if datatype == "hdf5":
        pytest.importorskip("h5py")
        from tools.make_synthetic_reads import main as make_reads

        kw["dataset"] = str(tmp_path / "reads.hdf5")
        make_reads([kw["dataset"], "--reads", "4", "--events", "300", "--num-levels", "16"])
    got, want = Dataset(datatype, **kw), JDataset(datatype, **kw)
    try:
        for stream in ("train", "valid"):
            _assert_batches_equal(got.fetch(stream), want.fetch(stream))
    finally:
        got.close()
        want.close()


def test_dataset_unknown_datatype():
    with pytest.raises(ValueError):
        Dataset("wav")


@pytest.mark.parametrize("max_iters,num_epochs,epoch_size", [(5, 10, 100), (100, 2, 3),
                                                             (7, 3, 2), (0, 1, 1)])
def test_epoch_counter_stops_where_jax_does(max_iters, num_epochs, epoch_size):
    def run(cls):
        c, n = cls(max_iters, num_epochs, epoch_size), 0
        while True:
            try:
                c.maybe_stop()
            except StopIteration:
                return n, c.counter, c.epochs
            c.tick()
            n += 1
    assert run(common.EpochCounter) == run(jcommon.EpochCounter)


def test_padding_helpers_equal_jax():
    rng = np.random.default_rng(3)
    sigs = [rng.standard_normal((n, 4)).astype(np.float32) for n in (5, 9, 2)]
    seqs = [rng.integers(1, 5, size=n).astype(np.int32) for n in (3, 0, 6)]
    for pad in (None, 12):
        np.testing.assert_array_equal(common.pad_stack_lc(sigs, pad), jcommon.pad_stack_lc(sigs, pad))
        np.testing.assert_array_equal(common.pad_stack_labels(seqs, pad),
                                      jcommon.pad_stack_labels(seqs, pad))
    np.testing.assert_array_equal(common.interleave_zeros(seqs[2]), jcommon.interleave_zeros(seqs[2]))
    with pytest.raises(ValueError):
        common.pad_stack_lc(sigs, 4)
    with pytest.raises(ValueError):
        common.pad_stack_labels(seqs, 5)
    b = common.Batch(common.pad_stack_lc(sigs), common.pad_stack_labels(seqs),
                     np.array([3, 0, 6], np.int32), np.array([5, 9, 2], np.int32))
    assert [f.name for f in dataclasses.fields(b)] == list(FIELDS)


def test_batch_to_device_and_prefetch():
    kw = dict(max_iters=3, num_epochs=1, epoch_size=10, batch_size=2, num_levels=16,
              lengths=(5, 9), pad_to=40, labels_pad_to=8, seed=1)
    want = PoreModelLoader(**kw).fetch()
    got = list(prefetch_to_device(PoreModelLoader(**kw), "cpu", size=2))
    assert len(got) == 3
    assert sorted(got[0]) == sorted(FIELDS)
    for f in FIELDS:
        assert got[0][f].device.type == "cpu"
        np.testing.assert_array_equal(got[0][f].numpy(), getattr(want, f))
    one = batch_to_device(want, torch.device("cpu"))
    assert one["signal"].dtype == torch.float32 and one["labels"].dtype == torch.int32

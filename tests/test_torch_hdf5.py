"""The port's HDF5 read path (data/hdf5.py, facade.Dataset("hdf5"),
cli.build_dataset, and train / evaluate on levels batches) against the JAX
package's on the CPU, on files that h5py writes into a temporary directory
in the layout of tools/make_synthetic_reads.py.

Every batch is integer data or a one-hot of it, so batches are held equal
bit for bit. The real-read overfit greedy-decodes the read's bases
exactly, as tests/test_realread_overfit.py does in JAX. Evaluate's printed
loss (4 decimals) is held to the eval step recomputed on the same batches
within 5e-5, its print's rounding; a levels batch and its host one-hot
score equal losses and logits to the bit (one-hot on the device is the
same array)."""
import copy
import json
import re
import threading
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import tests.make_golden_realread as mgr
from torch_threads import one_thread  # noqa: F401  (a fixture)
from tools.make_synthetic_reads import main as make_reads
from tools.make_synthetic_reads import make_read
from wavenet_speech_tpu import cli as jcli
from wavenet_speech_tpu.data import hdf5 as jhdf5
from wavenet_speech_tpu.data.gaussian_kmer import DEFAULT_KMER_MODEL
from wavenet_speech_tpu_torch import cli
from wavenet_speech_tpu_torch.data import hdf5
from wavenet_speech_tpu_torch.data.common import Batch
from wavenet_speech_tpu_torch.decoding.greedy import greedy_ctc_decode, labels2strings
from wavenet_speech_tpu_torch.facade import Dataset
from wavenet_speech_tpu_torch.models import WaveNet, WaveNetClassifier
from wavenet_speech_tpu_torch.training import (JointLoss, TrainState, build_optimizer,
                                               make_joint_train_step, param_tree)

h5py = pytest.importorskip("h5py")

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("signal", "labels", "label_lengths", "signal_lengths")
LINE = re.compile(r"eval loss over (\d+) batches: (\S+) \| basecall identity: (\S+)")
LEVELS = 16


def _assert_batches_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture
def reads(tmp_path):
    """6 reads of 300 events at 16 levels (tools/make_synthetic_reads.py)."""
    path = tmp_path / "reads.hdf5"
    make_reads([str(path), "--reads", "6", "--events", "300", "--num-levels", str(LEVELS),
                "--seed", "2"])
    return str(path)


def _producers():
    """The live QueueLoader producer threads (named after their target)."""
    return [t for t in threading.enumerate() if "(_producer)" in t.name]


@pytest.mark.parametrize("kw", [dict(), dict(device_onehot=True),
                                dict(device_onehot=True, pad_to=300, labels_pad_to=30),
                                dict(pad_to=300, labels_pad_to=30)],
                         ids=["onehot", "levels", "levels-padded", "onehot-padded"])
def test_ecoli_worker_fn_equals_jax(reads, kw):
    with h5py.File(reads, "r") as f:
        keys = sorted(f.keys())
        for seed in range(3):
            args = dict(batch_size=3, sample_lengths=(20, 26), num_levels=LEVELS,
                        debug_mode=True, **kw)
            got = hdf5.ecoli_worker_fn(f, keys, np.random.default_rng(seed), **args)
            want = jhdf5.ecoli_worker_fn(f, keys, np.random.default_rng(seed), **args)
            assert got[:2] == want[:2]  # the read and the subintervals
            _assert_batches_equal(got[2], want[2])
            assert got[2].signal.ndim == (2 if kw.get("device_onehot") else 3)
            plain = hdf5.ecoli_worker_fn(f, keys, np.random.default_rng(seed), **dict(
                args, debug_mode=False))
            _assert_batches_equal(plain, got[2])


def test_queue_loader_sequences_equal_jax_and_close(reads):
    """One producer a split: each split's batches come in the JAX loader's
    order; the train queue stops after max_iters batches (validation does
    not count), and close() leaves no producer alive."""
    kw = dict(num_workers=1, batch_size=2, sample_lengths=(20, 26), num_levels=LEVELS,
              seed=7, max_iters=3, queue_size=4, device_onehot=True)
    got, want = hdf5.QueueLoader(reads, **kw), jhdf5.QueueLoader(reads, **kw)
    try:
        assert (got.train_keys, got.valid_keys) == (want.train_keys, want.valid_keys)
        assert len(got.train_keys) == 4 and len(got.valid_keys) == 2
        for _ in range(6):
            _assert_batches_equal(got.dequeue("valid"), want.dequeue("valid"))
        for _ in range(3):
            _assert_batches_equal(got.dequeue("train"), want.dequeue("train"))
        for ld in (got, want):
            with pytest.raises(StopIteration):
                ld.dequeue("train", timeout=0.5)
        assert got._iterations == 3
    finally:
        got.close()
        want.close()
    assert not any(t.is_alive() for t in got._threads)
    assert not got.hdf5  # the file is closed


def _bucketed_file(path, n_buckets=3, n=5, L=40, S=9, seed=0):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f.attrs.update(num_buckets=n_buckets, bucket_size=n, signal_dim=LEVELS,
                       max_read_length=S, max_signal_length=L)
        for k in range(n_buckets):
            g = f.create_group(f"bucket_{k}")
            g.create_dataset("signals", data=rng.integers(0, LEVELS, size=(n, L)))
            g.create_dataset("reads", data=rng.integers(1, 5, size=(n, S)))
            g.create_dataset("read_lengths", data=rng.integers(3, S + 1, size=n))
            g.create_dataset("signal_lengths", data=rng.integers(L // 2, L + 1, size=n))


@pytest.mark.parametrize("one_hot", [True, False], ids=["onehot", "raw"])
def test_bucketed_loader_fetch_equals_jax(tmp_path, one_hot):
    path = str(tmp_path / "buckets.hdf5")
    _bucketed_file(path)
    got = hdf5.BucketedLoader(path, num_levels=LEVELS, one_hot=one_hot, seed=3)
    want = jhdf5.BucketedLoader(path, num_levels=LEVELS, one_hot=one_hot, seed=3)
    try:
        assert (got.num_buckets, got.bucket_size) == (want.num_buckets, want.bucket_size) == (3, 5)
        for batch_size in (2, 4, 8):
            g = got.fetch(batch_size)
            _assert_batches_equal(g, want.fetch(batch_size))
            assert g.signal.shape[-1] == (LEVELS if one_hot else 1)
    finally:
        got.close()
        want.close()


def ecoli_cfg(save_dir, data, **training):
    """configs/ecoli_hdf5_quality.json at 16 channels, 3 + 2 blocks, pool
    3, 3 reads a batch of 20-26 events (dwell 4-11 samples) padded to 300
    samples and 30 labels; steps_per_call 5, fixed_valid_batches 2, beam
    decoder W=4."""
    cfg = json.loads((ROOT / "configs" / "ecoli_hdf5_quality.json").read_text())
    cfg["model"]["base"].update(signal_dim=LEVELS, dilations=[1, 2, 4])
    cfg["model"]["classifier"].update(dilations=[1, 2], out_dim=LEVELS)
    cfg["training"].update(dict(
        training_data=data, save_dir=str(save_dir), batch_size=3, min_sample_length=20,
        max_sample_length=26, pad_to=300, labels_pad_to=30, max_iters=10, print_every=5,
        save_every=5, nworkers=2, fixed_valid_batches=2, eval_batches=2, beam_width=4,
        print_samples=False,
        optim=dict(cfg["training"]["optim"], warmup_steps=3, decay_steps=20)), **training)
    return cfg


def test_dataset_and_build_dataset_equal_jax(tmp_path, reads):
    """cli.build_dataset passes the JAX CLI's keys (nworkers, pad_to,
    labels_pad_to, device_onehot) into Dataset("hdf5"): the same loader
    settings as JAX's build_from_config, and, with one producer a split,
    the same batches."""
    cfg = ecoli_cfg(tmp_path / "run", reads)
    got, want = cli.build_dataset(cfg), jcli.build_from_config(copy.deepcopy(cfg))[0]
    try:
        assert got.signal_channels == want.signal_channels == 256  # as JAX's getattr default
        assert got.data._worker_cfg == want.data._worker_cfg == dict(
            batch_size=3, sample_lengths=(20, 26), num_levels=LEVELS, pad_to=300,
            labels_pad_to=30, device_onehot=True)
        assert len(got.data._threads) == len(want.data._threads) == 4  # 2 workers x 2 splits
        assert got.data.max_iters == want.data.max_iters == 10
    finally:
        got.close()
        want.close()
    cfg["training"]["nworkers"] = 1
    got, want = cli.build_dataset(cfg), jcli.build_from_config(copy.deepcopy(cfg))[0]
    try:
        for stream in ("valid", "train", "valid", "train"):
            g = got.fetch(stream)
            _assert_batches_equal(g, want.fetch(stream))
            assert g.signal.shape == (3, 300) and g.signal.dtype == np.int32
    finally:
        got.close()
        want.close()


def _rebuild_realread(tmp_path):
    """tests/make_golden_realread.py's fixture, windowed by the port's
    worker."""
    npz = np.load(DEFAULT_KMER_MODEL)
    bases, positions, chunks = make_read(np.random.default_rng(mgr.READ_SEED), mgr.N_EVENTS,
                                         npz["means"], npz["stdvs"], mgr.NUM_LEVELS)
    path = tmp_path / "one_read.hdf5"
    with h5py.File(path, "w") as f:
        g = f.create_group("read_0")
        g.create_dataset("quantized", (len(chunks),),
                         dtype=h5py.vlen_dtype(np.dtype("int64")))[:] = chunks
        g.create_group("raw").create_dataset("positions", data=positions)
        g.create_dataset("reference", data=bases)
    with h5py.File(path, "r") as f:
        return hdf5.ecoli_worker_fn(f, ["read_0"], np.random.default_rng(mgr.WORKER_SEED),
                                    batch_size=mgr.BATCH, sample_lengths=mgr.SAMPLE_LENGTHS,
                                    num_levels=mgr.NUM_LEVELS, debug_mode=True,
                                    device_onehot=True)


def test_port_worker_rebuilds_the_realread_fixture(tmp_path):
    want = dict(np.load(mgr.OUT, allow_pickle=False))
    read, subintervals, batch = _rebuild_realread(tmp_path)
    assert read == "read_0"
    for k in FIELDS:
        got = getattr(batch, k)
        assert got.dtype == want[k].dtype, k
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    np.testing.assert_array_equal(np.asarray(subintervals, np.int64), want["subintervals"])


def test_realread_overfit_on_the_port(one_thread):
    """tests/test_realread_overfit.py on the port: the joint WaveNet-CTC
    (256 levels, 32 channels, 3 + 6 blocks, pool 1; Adam 2e-3) on the
    fixture's levels batch crosses per-char CTC 0.3, stops below 0.02 (at
    most 2500 steps), and greedy-decodes the read's bases exactly."""
    fx = dict(np.load(mgr.OUT, allow_pickle=False))
    batch = {k: torch.from_numpy(fx[k].astype(np.int32)) for k in FIELDS}
    levels, C = mgr.NUM_LEVELS, 32
    layers = tuple((C, C, 2, d) for d in (1, 2, 4))
    base = WaveNet(levels, 2, layers, levels, softmax=False, device="cpu")
    clf = WaveNetClassifier(levels, 5, layers * 2, C, pool_kernel_size=1, softmax=False,
                            device="cpu")
    gen = torch.Generator().manual_seed(0)
    base.reset_parameters(gen)
    clf.reset_parameters(gen)
    tx = build_optimizer("adam", 2e-3)
    state = TrainState.create(param_tree(base, clf), tx)
    step = make_joint_train_step(base, clf, tx, JointLoss("joint"))
    frames, n_labels = batch["signal"].shape[1], float(batch["label_lengths"].sum())
    hit = per_char = None
    for i in range(2500):
        state, metrics = step(state, batch)
        per_char = float(metrics["ctc_loss"]) * frames / n_labels
        if hit is None and per_char < 0.3:
            hit = i
        if per_char < 0.02:
            break
    assert hit is not None, f"per-char CTC {per_char}"
    base.load_state_dict(state.params["base"])
    clf.load_state_dict(state.params["ctc"])
    with torch.no_grad():
        onehot = torch.nn.functional.one_hot(batch["signal"].long(), levels).float()
        decoded = greedy_ctc_decode(clf(base(onehot)))
    expected = labels2strings([fx["labels"][b, :fx["label_lengths"][b]]
                               for b in range(len(fx["labels"]))])
    assert decoded == expected


def _record(calls, fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        calls.append(out)
        return out
    return wrapped


def test_train_then_evaluate_on_levels_batches(tmp_path, reads, capsys, one_thread):
    """`python -m wavenet_speech_tpu_torch.cli train` twice (10 steps, then
    resumed to 20) and `evaluate` with --device cpu on an ecoli-style hdf5
    config: K=5 steps a call on (5, 3, 300) int32 levels, two fixed
    validation batches, loader threads closed at each exit; evaluate's
    printed loss is the eval step's on the batches it drew, and a levels
    batch scores as its host one-hot does."""
    cfg = ecoli_cfg(tmp_path / "run", reads)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    shapes = []
    to_device = cli.batch_to_device
    with mock.patch.object(cli, "batch_to_device",
                           lambda b, d: shapes.append((b.signal.shape, b.signal.dtype))
                           or to_device(b, d)):
        for _ in range(2):
            assert cli.main(["train", str(path), "--device", "cpu"]) == 0
            assert not _producers()
    assert shapes.count(((5, 3, 300), np.int32)) == 4  # 2 K-step calls a run
    assert shapes.count(((3, 300), np.int32)) == 4     # 2 fixed validation batches a run
    run = tmp_path / "run"
    assert sorted(int(p.name) for p in (run / "ckpts").iterdir()) == [5, 10, 15, 20]
    assert "resumed from" in (run / "logs" / "messages.log").read_text()
    lines = [json.loads(l) for l in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines] == [5, 10, 15, 20]
    assert all(np.isfinite([l["train_loss"], l["valid_loss"]]).all() for l in lines)

    drawn = []
    with mock.patch.object(Dataset, "fetch", _record(drawn, Dataset.fetch)):
        assert cli.main(["evaluate", str(path), "--device", "cpu"]) == 0
    assert not _producers()
    n, loss, _ = LINE.search(capsys.readouterr().out).groups()
    assert int(n) == len(drawn) == 2
    ds, model, state, _, eval_fn, _ = cli.build_from_config(copy.deepcopy(cfg), "cpu")
    ds.close()
    state = cli.restore_checkpoint(str(run / "ckpts"), state)
    model.load_params(state.params)
    want = [float(eval_fn(state.params, cli.batch_to_device(b, "cpu"))["total_loss"])
            for b in drawn]
    assert abs(float(loss) - np.mean(want)) <= 5e-5
    b = drawn[0]
    onehot = Batch(np.eye(LEVELS, dtype=np.float32)[b.signal], b.labels, b.label_lengths,
                   b.signal_lengths)
    got = [eval_fn(state.params, cli.batch_to_device(x, "cpu")) for x in (b, onehot)]
    assert all(torch.equal(got[0][k], got[1][k]) for k in got[0])
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(onehot.signal)),
                           model(torch.nn.functional.one_hot(
                               torch.from_numpy(b.signal).long(), LEVELS).float()))


def _valid_runs_dry_after(n, module):
    """QueueLoader.dequeue of ``module`` with the valid queue empty after n
    batches."""
    dequeue, served = module.QueueLoader.dequeue, []

    def patched(self, from_queue="train", timeout=1.0):
        if from_queue == "valid" and len(served) >= n:
            raise StopIteration
        out = dequeue(self, from_queue, timeout)
        if from_queue == "valid":
            served.append(out)
        return out

    return mock.patch.object(module.QueueLoader, "dequeue", patched)


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("fixed_valid", [3, 0])
def test_validation_stream_running_dry_gives_nan(tmp_path, reads, side, fixed_valid):
    """max_iters 2 < fixed_valid_batches 3 and a valid queue that runs dry
    after one batch: no crash in either CLI. With fixed batches the one
    batch drawn scores every print; without, a print's validation fetch
    raises StopIteration and logs nan, as in the JAX CLI."""
    cfg = ecoli_cfg(tmp_path / side, reads, max_iters=2, print_every=1, save_every=2,
                    steps_per_call=1, fixed_valid_batches=fixed_valid, nworkers=1)
    module, train = ((hdf5, lambda c: cli.train_with_result(c, "cpu")) if side == "port"
                     else (jhdf5, jcli.train_with_result))
    with _valid_runs_dry_after(1, module):
        result = train(cfg)
    assert result["steps"] == 2
    lines = [json.loads(l) for l in
             (tmp_path / side / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines] == [1, 2]
    vlosses = [l["valid_loss"] for l in lines]
    if fixed_valid:
        assert np.isfinite(vlosses).all() and vlosses[0] != vlosses[1]
    else:
        assert lines[0]["valid_loss"] is not None and np.isfinite(lines[0]["valid_loss"])
        assert vlosses[1] is None or np.isnan(vlosses[1])

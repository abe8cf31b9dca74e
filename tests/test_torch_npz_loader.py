"""data/npz_loader.py against the JAX package's NPZQueueLoader, on the same
shards and seed. The workers are numpy on both sides, drawing from the same
worker seeds, so every batch must be equal to the bit, field by field, with
the same dtypes. JAX forks its workers, the port spawns them; with two
workers the queue's order depends on the workers' timing, so the multiset
of batches is compared. Each test spawns as few workers as its check needs,
and every dequeue waits up to 20 s (JAX's own test's timeout), so a slow
worker start under a loaded machine does not end a stream early."""
import hashlib

import numpy as np
import pytest

from wavenet_speech_tpu.data.npz_loader import NPZQueueLoader as JNPZQueueLoader
from wavenet_speech_tpu_torch.data import npz_loader
from wavenet_speech_tpu_torch.data.npz_loader import NPZQueueLoader

FIELDS = ("signal", "labels", "label_lengths", "signal_lengths")
TIMEOUT = 20.0


def _make_shards(tmp_path, n_shards=2, per_shard=12, seed=0, padded=False):
    """JAX's test's shards (tests/test_npz_loader.py); padded: the 2-D form
    with signal_lengths / read_lengths."""
    rng = np.random.default_rng(seed)
    for s in range(n_shards):
        sigs = [rng.integers(0, 64, size=rng.integers(30, 50)) for _ in range(per_shard)]
        reads = [rng.integers(1, 5, size=rng.integers(5, 10)) for _ in range(per_shard)]
        if padded:
            sl = np.array([len(x) for x in sigs])
            rl = np.array([len(x) for x in reads])
            ps = np.zeros((per_shard, sl.max()), np.int64)
            pr = np.zeros((per_shard, rl.max()), np.int64)
            for i in range(per_shard):
                ps[i, :sl[i]], pr[i, :rl[i]] = sigs[i], reads[i]
            np.savez(tmp_path / f"shard_{s}.npz", signals=ps, reads=pr,
                     signal_lengths=sl, read_lengths=rl)
        else:
            np.savez(tmp_path / f"shard_{s}.npz", signals=np.array(sigs, dtype=object),
                     reads=np.array(reads, dtype=object), allow_pickle=True)
    return str(tmp_path / "shard_*.npz")


def _drain(loader):
    out = []
    try:
        while True:
            out.append(loader.dequeue(timeout=TIMEOUT))
    except StopIteration:
        pass
    finally:
        loader.close()
    return out


def _assert_equal(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _digest(batch):
    h = hashlib.sha256()
    for f in FIELDS:
        a = getattr(batch, f)
        h.update(str((a.dtype, a.shape)).encode() + a.tobytes())
    return h.hexdigest()


def test_one_worker_matches_jax_and_max_iters_ends_the_stream(tmp_path):
    """One worker and a seed: JAX's batches to the bit; the first equals a
    recomputation here from the worker's seed; max_iters ends the stream;
    close() leaves no worker alive."""
    pattern = _make_shards(tmp_path)
    kw = dict(batch_size=4, num_levels=64, num_workers=1, max_iters=5, seed=1)
    want = _drain(JNPZQueueLoader(pattern, **kw))
    loader = NPZQueueLoader(pattern, **kw)
    got = _drain(loader)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _assert_equal(g, w)
    rng = np.random.default_rng(loader.worker_seeds[0])
    again = npz_loader.make_batch(loader.paths, rng, 4, 64, True)
    for f, a in zip(FIELDS, again):
        np.testing.assert_array_equal(getattr(got[0], f), a)
    with pytest.raises(StopIteration):
        loader.dequeue(timeout=TIMEOUT)
    assert not any(p.is_alive() for p in loader._procs)
    assert all(p.exitcode is not None for p in loader._procs)


def test_two_workers_give_jax_multiset_of_batches(tmp_path):
    """Two workers, max_iters a multiple of the worker count: each worker
    makes max_iters / 2 batches, so the set of batches is JAX's whatever the
    order they arrive in."""
    pattern = _make_shards(tmp_path, n_shards=3)
    kw = dict(batch_size=3, num_levels=64, num_workers=2, max_iters=6, seed=7)
    want = _drain(JNPZQueueLoader(pattern, **kw))
    loader = NPZQueueLoader(pattern, **kw)
    got = _drain(loader)
    assert len(got) == len(want) == 6
    assert sorted(map(_digest, got)) == sorted(map(_digest, want))
    assert not any(p.is_alive() for p in loader._procs)


@pytest.mark.parametrize("padded,one_hot", [(True, True), (False, False)],
                         ids=["padded-2d-shards", "one_hot-False"])
def test_shard_forms_and_raw_signals_match_jax(tmp_path, padded, one_hot):
    pattern = _make_shards(tmp_path, padded=padded, seed=3)
    kw = dict(batch_size=5, num_levels=64, one_hot=one_hot, num_workers=1, max_iters=3,
              seed=0)
    want = _drain(JNPZQueueLoader(pattern, **kw))
    got = _drain(NPZQueueLoader(pattern, **kw))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_equal(g, w)
    width = 64 if one_hot else 1
    assert got[0].signal.shape[2] == width and got[0].signal.dtype == np.float32


def test_missing_glob_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        NPZQueueLoader(str(tmp_path / "nope_*.npz"))

"""tools/fit_durations.py and tools/dump_distributions.py against the JAX
package's. Both are numpy, scipy and h5py host code, so every output must
be equal to JAX's to the bit: the parsed FASTA, the label arrays, the
HDF5 genome (read back dataset by dataset), the fitted duration table and
the read histograms. C12 is pinned: the fitted row's second column is
scipy's Gamma *scale*, the untouched rows keep the prior *rate*, and
str2idx weights position k by 4^k, unlike data.gaussian_kmer.kmer_ids."""
import h5py
import numpy as np
import pytest

from wavenet_speech_tpu.tools import dump_distributions as jdump
from wavenet_speech_tpu.tools import fit_durations as jfit
from wavenet_speech_tpu_torch.data.gaussian_kmer import kmer_ids
from wavenet_speech_tpu_torch.data.raw_signal import RawSignalGenerator
from wavenet_speech_tpu_torch.tools import dump_distributions as dump
from wavenet_speech_tpu_torch.tools import fit_durations as fit

EAF_HEADER = "\t".join(jfit.EAF_HEADERS)


def _h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(
            name, (obj[()], dict(obj.attrs)) if isinstance(obj, h5py.Dataset) else None))
    return out


def test_fasta_labels_and_kmer_indices_match_jax(tmp_path):
    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1 description\nACGT\nNNAC\n\n>chr2\nggttaa\n>empty\n")
    assert list(dump.read_fasta(str(fa))) == list(jdump.read_fasta(str(fa))) == \
        [("chr1", "ACGTNNAC"), ("chr2", "ggttaa"), ("empty", "")]
    for s in ("ACGTN", "acgtnNRY", "", "TTTTAAAACCCCGGGG"):
        got, want = dump.string_to_array(s), jdump.string_to_array(s)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for idx in range(1024):
        assert fit.idx2str(idx) == jfit.idx2str(idx)
        assert fit.str2idx(fit.idx2str(idx)) == jfit.str2idx(jfit.idx2str(idx)) == idx
    assert fit.str2idx("acgta") == jfit.str2idx("acgta")


def test_str2idx_is_not_kmer_ids_order():
    """C12, second part: the table's row of a 5-mer is not its kmer_ids id
    (position k weighs 4^k here, 4^(4-k) there), and the bases map A,G,C,T
    to 0..3 in both."""
    kmer = "AGCTT"
    nts = np.array([{"A": 1, "G": 2, "C": 3, "T": 4}[c] for c in kmer])
    assert fit.str2idx(kmer) == 0 + 1 * 4 + 2 * 16 + 3 * 64 + 3 * 256 == 996
    assert int(kmer_ids(nts, trim=0)[0]) == 0 * 256 + 1 * 64 + 2 * 16 + 3 * 4 + 3 == 111


def test_dump_reference_equals_jax_and_feeds_raw_signal_generator(tmp_path):
    rng = np.random.default_rng(0)
    seqs = {f"contig_{i}": "".join("AGCTN"[j] for j in rng.integers(0, 5, size=n))
            for i, n in enumerate((2000, 1500))}
    fa = tmp_path / "ref.fa"
    fa.write_text("".join(f">{k} extra words\n{v[:700]}\n{v[700:]}\n" for k, v in seqs.items()))
    dump.dump_reference(str(fa), str(tmp_path / "port.hdf5"))
    jdump.dump_reference(str(fa), str(tmp_path / "jax.hdf5"))
    got, want = _h5_tree(tmp_path / "port.hdf5"), _h5_tree(tmp_path / "jax.hdf5")
    assert got.keys() == want.keys() == {"contig_0", "contig_0/contig", "contig_1",
                                         "contig_1/contig"}
    for k, v in want.items():
        if v is not None:
            assert got[k][0].dtype == v[0].dtype == np.int32
            np.testing.assert_array_equal(got[k][0], v[0])
            assert got[k][1] == v[1]
    gen = RawSignalGenerator(kmer_model=None, reference_hdf=str(tmp_path / "port.hdf5"),
                             read_length_model=(20, 30), sample_rate=50.0, batch_size=2,
                             seed=1)
    b = gen.fetch()
    gen.close()
    assert b.signal.shape[0] == 2 and np.isfinite(b.signal).all()
    assert (b.labels[b.labels > 0] <= 4).all() and (b.label_lengths >= 20).all()


def _write_tsv(path, rows):
    path.write_text("\n".join([EAF_HEADER] + ["\t".join(map(str, r)) for r in rows]) + "\n")


def _row(pos, evt, kmer, dur):
    return ["ctg", pos, kmer, 0, "t", evt, 80.0, 1.0, dur, 0.0, kmer, 80.0, 1.0, 0.0]


def test_fit_from_tsv_equals_jax_and_keeps_scale_in_the_rate_column(tmp_path):
    """Three k-mers with enough samples, one below min_samples, windows the
    filters drop: the table equals JAX's to the bit. C12: a fitted row's
    second column is scipy's scale (~1/rate); the others keep the prior
    rate."""
    rng = np.random.default_rng(2)
    rows, pos, evt, durations = [], 0, 0, {}
    fitted = {"AGCTA": (3.0, 0.002), "TTGCA": (2.0, 0.004), "CCCCC": (5.0, 0.001)}
    for kmer, (shape, scale) in fitted.items():
        durations[kmer] = rng.gamma(shape, scale, size=400)
        for d in durations[kmer]:
            pos, evt = pos + 1, evt + 1
            rows.append(_row(pos, evt, kmer, d))
    for d in (0.01, 0.02):                   # 2 < min_samples: keeps the prior
        pos, evt = pos + 1, evt + 1
        rows.append(_row(pos, evt, "GGGGG", d))
    rows += [_row(pos + 1, evt + 1, "ANAAA", 0.5), _row(pos + 1, evt + 2, "AAAAA", 0.5),
             _row(pos + 2, evt + 2, "AAAAA", 0.5), _row(pos + 3, evt + 3, "AAAAA", 0.5)]
    tsv = tmp_path / "ea.tsv"
    _write_tsv(tsv, rows)
    got = fit.fit_from_tsv(str(tsv), str(tmp_path / "port.npy"))
    want = jfit.fit_from_tsv(str(tsv), str(tmp_path / "jax.npy"))
    assert got.dtype == want.dtype == np.float32 and got.shape == (1024, 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), want)
    from scipy import stats

    # every TTGCA row is the middle of an admissible window (the file's first
    # row never is): its row holds scipy's (shape, scale) of all 400
    a, _loc, scale = stats.gamma.fit(np.array([float(str(d)) for d in durations["TTGCA"]]))
    np.testing.assert_array_equal(got[fit.str2idx("TTGCA")], np.float32([a, scale]))
    for kmer, (shape, scale) in fitted.items():
        k = fit.str2idx(kmer)
        assert got[k, 1] < 0.1                     # a scale (~1/rate), not a rate
        assert abs(got[k, 0] - shape) / shape < 0.5
    untouched = [k for k in range(1024) if k not in {fit.str2idx(m) for m in fitted}]
    np.testing.assert_array_equal(got[untouched], np.float32(
        [[fit.DEFAULT_SHAPE, fit.DEFAULT_RATE]] * len(untouched)))
    assert fit.DEFAULT_RATE > 500                  # the prior column is a rate


@pytest.mark.parametrize("case", ["position", "event", "N", "short"])
def test_admissibility_filters_match_jax(case):
    base = [dict(zip(jfit.EAF_HEADERS, map(str, _row(p, p, "AAAAA", 0.5)))) for p in (1, 2, 3)]
    if case == "position":
        base[1]["position"] = "1"
    elif case == "event":
        base[2]["event_index"] = "2"
    elif case == "N":
        base[1]["reference_kmer"] = "AANAA"
    else:
        base = base[:2]
    assert fit.admissible(base) is jfit.admissible(base) is False
    ok = [dict(zip(jfit.EAF_HEADERS, map(str, _row(p, p, "AAAAA", 0.5)))) for p in (1, 2, 3)]
    assert fit.admissible(ok) is jfit.admissible(ok) is True


def test_dump_distributions_main_equals_jax(tmp_path):
    """main with --reads: the genome and both histograms of a reads HDF5 in
    the reference layout (/<read>/raw/samples, /<read>/reference)."""
    fa = tmp_path / "ref.fa"
    fa.write_text(">c\nACGTACGTACGTNNAC\n>d\nggttaacc\n")
    rng = np.random.default_rng(5)
    reads = tmp_path / "reads.hdf5"
    with h5py.File(reads, "w") as f:
        for r in range(4):
            g = f.create_group(f"read_{r}")
            n_events = int(rng.integers(5, 12))
            dt = h5py.vlen_dtype(np.dtype("float32"))
            samples = g.create_group("raw").create_dataset("samples", (n_events,), dtype=dt)
            for e in range(n_events):
                samples[e] = rng.normal(size=int(rng.integers(1, 9))).astype(np.float32)
            g.create_dataset("reference", data=rng.integers(1, 5, size=n_events + 4))
    for side, main in (("port", dump.main), ("jax", jdump.main)):
        out = tmp_path / side
        assert main(["--reference", str(fa), "--reads", str(reads), "--outdir", str(out)]) == 0
    for name in ("sample_counts.npy", "read_lengths.npy"):
        got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert got.dtype == want.dtype == np.int32 and got.sum() > 0
        np.testing.assert_array_equal(got, want)
    got, want = _h5_tree(tmp_path / "port" / "reference.hdf5"), \
        _h5_tree(tmp_path / "jax" / "reference.hdf5")
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["c/contig"][0], want["c/contig"][0])
    np.testing.assert_array_equal(got["d/contig"][0], [2, 2, 4, 4, 1, 1, 3, 3])

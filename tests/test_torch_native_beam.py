"""The port's native C++ beam engine (wavenet_speech_tpu_torch/native)
against the JAX package's numpy prefix beam (decoding.prefix_beam) and its
device beam (ctc_beam_search_jax), on the CPU. Not against JAX's own
native library, whose in-place build is not safe across processes.

Held: labels, lengths and emission times equal; scores within SCORE_RTOL
(the native engine sums in double, JAX in float64 (numpy) or float32);
over per-sequence lengths, several thread counts, a label cap and
``Decoder(engine="native")``. The build: concurrent first builds in four
processes leave one whole library; a failed build raises; an unloadable
library is rebuilt; an edited source gets a library of its own."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.decoding import beam_search_decode
from wavenet_speech_tpu.decoding.ctc_beam_device import ctc_beam_search_jax
from wavenet_speech_tpu.facade import Decoder as JDecoder
from wavenet_speech_tpu_torch.facade import Decoder
from wavenet_speech_tpu_torch.native import ctc_beam
from wavenet_speech_tpu_torch.native.ctc_beam import ctc_beam_search_native

ROOT = Path(__file__).resolve().parent.parent
SCORE_RTOL = 1e-5


def logits_of(seed, B=4, T=30, C=5, scale=2.0):
    return (np.random.default_rng(seed).standard_normal((B, T, C)) * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_jax_prefix_beam(seed):
    logits = logits_of(seed)
    labels, lens, scores = ctc_beam_search_native(logits, beam_width=7)
    want, want_scores = beam_search_decode(logits, beam_width=7)
    for b in range(logits.shape[0]):
        np.testing.assert_array_equal(labels[b, :lens[b]], want[b])
        assert not labels[b, lens[b]:].any()
    np.testing.assert_allclose(scores, want_scores, rtol=SCORE_RTOL)


@pytest.mark.parametrize("threads", [0, 1, 3, 8])
def test_native_matches_jax_device_beam_with_lengths(threads):
    logits = logits_of(5, B=6, T=40)
    lengths = np.array([40, 7, 25, 1, 33, 18], np.int32)
    labels, lens, scores, times = ctc_beam_search_native(
        logits, beam_width=5, lengths=lengths, num_threads=threads, return_times=True)
    p, n, s, t = (np.asarray(x) for x in ctc_beam_search_jax(
        jnp.asarray(logits), jnp.asarray(lengths), beam_width=5, return_times=True))
    np.testing.assert_array_equal(lens, n[:, 0])
    for b in range(len(lengths)):
        np.testing.assert_array_equal(labels[b, :lens[b]], p[b, 0, :n[b, 0]])
        np.testing.assert_array_equal(times[b, :lens[b]], t[b, 0, :n[b, 0]])
    np.testing.assert_allclose(scores, s[:, 0], rtol=SCORE_RTOL)
    want, want_scores = beam_search_decode(logits, beam_width=5, lengths=lengths)
    for b in range(len(lengths)):
        np.testing.assert_array_equal(labels[b, :lens[b]], want[b])
    np.testing.assert_allclose(scores, want_scores, rtol=SCORE_RTOL)


def test_native_label_cap_and_log_input_match_jax_device_beam():
    logits = logits_of(9, B=3, T=50)
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    labels, lens, scores, times = ctc_beam_search_native(
        lp, beam_width=7, max_label_len=6, log_input=True, return_times=True)
    p, n, s, t = (np.asarray(x) for x in ctc_beam_search_jax(
        jnp.asarray(lp), beam_width=7, max_label_len=6, log_input=True, return_times=True))
    assert labels.shape == times.shape == (3, 6) and (lens == 6).all()
    np.testing.assert_array_equal(lens, n[:, 0])
    np.testing.assert_array_equal(labels, p[:, 0])
    np.testing.assert_array_equal(times, t[:, 0])
    np.testing.assert_allclose(scores, s[:, 0], rtol=SCORE_RTOL)


def test_decoder_native_engine_matches_jax_decoder():
    logits = logits_of(11, B=3, T=25)
    lengths = np.array([25, 12, 20], np.int32)
    got = Decoder("beam", beam_width=7, engine="native").decode(logits, lengths,
                                                                return_times=True)
    # JAX's native engine builds in place (C7); its device engine gives the
    # same decode, times included
    want = JDecoder("beam", beam_width=7, engine="device").decode(
        jnp.asarray(logits), jnp.asarray(lengths), return_times=True)
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_allclose(got[0], want[0], rtol=SCORE_RTOL)
    from_tensor = Decoder("beam", beam_width=7, engine="native").decode(
        torch.from_numpy(logits), torch.from_numpy(lengths))
    assert from_tensor == got[:2]


def test_native_argument_checks():
    with pytest.raises(ValueError, match="lengths"):
        ctc_beam_search_native(logits_of(0), lengths=np.ones(3, np.int32))
    with pytest.raises(ValueError, match="blank"):
        ctc_beam_search_native(logits_of(0), blank=5)
    with pytest.raises(ValueError, match=r"\(B, T, C\)"):
        ctc_beam_search_native(logits_of(0)[0])


CHILD = """
import json, sys
import numpy as np
from wavenet_speech_tpu_torch.native import ctc_beam
ctc_beam._lib = ctc_beam.load_library(sys.argv[1])
logits = (np.random.default_rng(3).standard_normal((4, 30, 5)) * 2).astype(np.float32)
labels, lens, scores = ctc_beam.ctc_beam_search_native(logits, beam_width=7)
print(json.dumps([labels.tolist(), lens.tolist(), scores.tolist()]))
"""


def test_concurrent_first_builds_leave_one_whole_library(tmp_path):
    """Four processes build into one fresh directory at once: each loads a
    whole library and decodes with it; one library file is left, and no
    temporary file."""
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(build)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    labels, lens, scores = ctc_beam_search_native(logits_of(3), beam_width=7)
    for out, _ in outs:
        got = json.loads(out)
        assert got[0] == labels.tolist() and got[1] == lens.tolist()
        np.testing.assert_array_equal(got[2], scores)
    assert sorted(p.name for p in build.iterdir()) == [".lock", ctc_beam.lib_path(build).name]


def test_unloadable_library_is_rebuilt_and_edited_source_gets_its_own(tmp_path, monkeypatch):
    path = ctc_beam.lib_path(tmp_path)
    path.write_bytes(b"not a shared library")
    lib = ctc_beam.load_library(tmp_path)
    assert hasattr(lib, ctc_beam.ENTRY) and path.stat().st_size > 1000
    edited = tmp_path / "ctc_beam.cc"
    edited.write_text(ctc_beam.SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(ctc_beam, "SRC", edited)
    assert ctc_beam.lib_path(tmp_path) != path


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(ctc_beam, "SRC", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ctc_beam.load_library(tmp_path / "build")
    assert not any(p.suffix == ".tmp" for p in (tmp_path / "build").iterdir())
    # a process whose build failed raises on every decode, as JAX's does
    monkeypatch.setattr(ctc_beam, "_lib", None)
    monkeypatch.setattr(ctc_beam, "_build_error", "g++ failed: test")
    assert not ctc_beam.native_available() and ctc_beam.build_error() == "g++ failed: test"
    with pytest.raises(RuntimeError, match="unavailable"):
        ctc_beam_search_native(logits_of(0))
    with pytest.raises(RuntimeError, match="unavailable"):
        Decoder("beam", engine="native").decode(logits_of(0))

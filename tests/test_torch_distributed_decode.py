"""The distributed beam decoders (wavenet_speech_tpu_torch/decoding/
distributed.py) on 4 gloo ranks, (data 2, seq 2), against the JAX
package's ``distributed_beam_decode`` and ``seq_sharded_beam_decode`` on
the conftest's virtual devices, on __graft_entry__.py's biased-blank
logits (B=4, T=128, C=5, W=7, one ragged sequence, S = T / 2). Prefixes
and plens equal, scores within 1e-5 (float32 sums in another order: the
port's beam runs a frame loop, JAX's a scan). Also the errors for a batch
or a time axis that the mesh does not divide, and the single-device
decode on a one-rank mesh."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.decoding.distributed import distributed_beam_decode as j_batch_decode
from wavenet_speech_tpu.decoding.distributed import seq_sharded_beam_decode as j_seq_decode
from wavenet_speech_tpu.parallel import make_mesh as j_make_mesh
from wavenet_speech_tpu_torch.decoding import distributed_beam_decode, seq_sharded_beam_decode
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import ctc_beam_search
from wavenet_speech_tpu_torch.parallel import make_mesh, run_ranks
from wavenet_speech_tpu_torch.parallel.mesh import Mesh

import torch_rank_programs

W = 7
DATA, SEQ = 2, 2


def _logits():
    """__graft_entry__.py's decode inputs at data=2, seq=2."""
    rng = np.random.default_rng(11)
    B, T = 2 * DATA, 64 * SEQ
    logits = (3.0 * rng.standard_normal((B, T, 5))).astype(np.float32)
    logits[rng.random((B, T)) < 0.7, 0] += 6.0
    lens = np.full((B,), T, np.int32)
    lens[1] = T - T // 4
    return logits, lens, T // 2


@pytest.fixture(scope="module")
def decoded():
    logits, lens, S = _logits()
    return run_ranks(torch_rank_programs.decoders, DATA * SEQ, "gloo", (DATA, SEQ), logits, lens,
                     W, S, timeout=180.0)


def _assert_decodes_match(got, want, S):
    plens = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), plens)
    live = np.arange(S)[None, None, :] < plens[:, :, None]
    np.testing.assert_array_equal(np.where(live, got[0].numpy(), 0),
                                  np.where(live, np.asarray(want[0]), 0))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-5)


def test_batch_sharded_decode_matches_jax(decoded):
    logits, lens, S = _logits()
    want = j_batch_decode(j_make_mesh(data=DATA, model=1, seq=SEQ), logits, lens,
                          beam_width=W, max_label_len=S)
    for out in decoded:
        _assert_decodes_match(out["batch"], want, S)


@pytest.fixture(scope="module")
def jax_seq_decode():
    logits, lens, S = _logits()
    return j_seq_decode(j_make_mesh(data=DATA, model=1, seq=SEQ), logits, lens, beam_width=W,
                        max_label_len=S, data_sharded=True)


@pytest.mark.parametrize("data_sharded", [False, True])
def test_seq_sharded_decode_matches_jax(decoded, jax_seq_decode, data_sharded):
    """The beam state passed from seq rank to seq rank, the rows over
    "data" too or not: JAX's result (rows over "data"; its rows decode
    alone either way), and the times of every live label."""
    _, _, S = _logits()
    want = jax_seq_decode
    plens = np.asarray(want[1])
    live = np.arange(S)[None, None, :] < plens[:, :, None]
    for out in decoded:
        got = out["seq_data" if data_sharded else "seq"]
        _assert_decodes_match(got, want, S)
        np.testing.assert_array_equal(np.where(live, got[3].numpy(), 0),
                                      np.where(live, np.asarray(want[3]), 0))


def test_decoders_on_one_rank_are_the_beam_search():
    logits, lens, S = _logits()
    mesh = make_mesh(device="cpu")
    want = ctc_beam_search(torch.from_numpy(logits), lens, beam_width=W, max_label_len=S)
    for got in (distributed_beam_decode(mesh, logits, lens, beam_width=W, max_label_len=S),
                seq_sharded_beam_decode(mesh, logits, lens, beam_width=W, max_label_len=S)[:3]):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_decoders_refuse_shapes_the_mesh_does_not_divide():
    mesh = Mesh({"data": 3, "model": 1, "seq": 3}, 0, torch.device("cpu"), {}, {})
    x = np.zeros((4, 8, 5), np.float32)
    with pytest.raises(ValueError, match="not divisible by data axis"):
        distributed_beam_decode(mesh, x)
    with pytest.raises(ValueError, match="not divisible by seq axis"):
        seq_sharded_beam_decode(mesh, x)
    with pytest.raises(ValueError, match="not divisible by data axis"):
        seq_sharded_beam_decode(mesh, np.zeros((4, 9, 5), np.float32), data_sharded=True)
    with pytest.raises(ValueError, match="not divisible by data axis"):
        j_batch_decode(j_make_mesh(data=3, model=1, seq=1), jnp.zeros((4, 8, 5)))

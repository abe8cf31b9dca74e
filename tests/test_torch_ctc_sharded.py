"""The port's sequence-sharded CTC (B3: ops/ctc_scan.py ``ctc_fwd`` /
``ctc_bwd`` with a carry; parallel/ctc_sharded.py) against the JAX package
on the CPU. The segments against JAX's segment kernels
(``ctc_fwd_segment`` / ``ctc_bwd_segment``) in interpret mode, with a carry
from the neighbouring segments and t_offset > 0; the chained loss on gloo
ranks (``run_ranks``) against JAX ``ctc_loss_seq_sharded(impl="pallas")``
on the virtual devices and the single-device loss, values and gradients,
on seq=2, seq=3, seq=4 and data=2 x seq=2, with sequences that end inside
an interior shard.
Tolerance: rtol and atol 1e-5 for values; rtol 1e-4, atol 1e-6 for
gradients (f32, the same recursion with sums in another order), as
tests/test_ctc_sharded.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.ops.ctc import ctc_loss_per_seq as j_ctc_loss_per_seq
from wavenet_speech_tpu.ops.pallas.ctc import ctc_bwd_segment as j_bwd_segment
from wavenet_speech_tpu.ops.pallas.ctc import ctc_fwd_segment as j_fwd_segment
from wavenet_speech_tpu.parallel import make_mesh as j_make_mesh
from wavenet_speech_tpu.parallel.ctc_sharded import (
    ctc_loss_seq_sharded as j_ctc_loss_seq_sharded)
from wavenet_speech_tpu_torch.ops.ctc import NEG, ctc_loss_per_seq
from wavenet_speech_tpu_torch.ops.ctc_scan import ctc_bwd, ctc_fwd
from wavenet_speech_tpu_torch.parallel import ctc_loss_seq_sharded, make_mesh, run_ranks

import torch_rank_programs

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
TIMEOUT = 180.0


def _batch(B=4, T=48, S=7, C=5, seed=7):
    """tests/test_ctc_sharded.py:12-18's batch, with lengths that end
    inside interior shards at seq=2 and seq=4 (T/4 = 12)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    labels = rng.integers(1, C, size=(B, S)).astype(np.int32)
    lab = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    tl = np.array([T, 33, 22, 15], np.int32)
    return logits, tl, labels, lab


def _ext(logits, labels):
    """(lp_ext_t (T, B, J), skipadd (B, J)) by the JAX package's preamble."""
    from wavenet_speech_tpu.ops.ctc import _extend_labels, _gather_ext
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    ext, allow = _extend_labels(jnp.asarray(labels), 0)
    return (np.asarray(jnp.transpose(_gather_ext(lp, ext), (1, 0, 2))),
            np.asarray(jnp.where(allow, 0.0, NEG)))


@pytest.mark.parametrize("seg", [0, 1, 2])
def test_segment_functions_match_jax(seg):
    """Segment seg of 3 (16 frames each): the carries it gets from JAX's
    segments before and after it, t_offset = 16 * seg."""
    logits, tl, labels, lab = _batch()
    lp, skip = _ext(logits, labels)
    T, B, J = lp.shape
    Tl = T // 3
    jargs = (jnp.asarray(skip), jnp.asarray(tl), jnp.asarray(lab))
    alpha = jnp.full((B, J), NEG, jnp.float32)
    fwd = []
    for s in range(3):
        ll, alphas, alpha_out = j_fwd_segment(jnp.asarray(lp[s * Tl:(s + 1) * Tl]), *jargs,
                                              alpha, s * Tl, interpret=True)
        fwd.append((alpha, ll, alphas[:Tl], alpha_out))
        alpha = alpha_out
    ll_global = fwd[-1][1]
    cot = jnp.asarray(np.random.default_rng(2).uniform(-2, 2, (B,)).astype(np.float32))
    lpb = jnp.full((B, J), NEG, jnp.float32)
    bwd = {}
    for s in reversed(range(3)):
        grad, lpb_out = j_bwd_segment(jnp.asarray(lp[s * Tl:(s + 1) * Tl]), fwd[s][2], *jargs,
                                      ll_global, cot, lpb, s * Tl, interpret=True)
        bwd[s] = (lpb, grad, lpb_out)
        lpb = lpb_out

    alpha_in, ll_j, alphas_j, aout_j = fwd[seg]
    lpb_in, grad_j, lpb_out_j = bwd[seg]
    t = lambda a: torch.from_numpy(np.array(a))
    tlp, tskip, ttl, tlab = t(lp[seg * Tl:(seg + 1) * Tl]), t(skip), t(tl), t(lab)
    counts = lambda: (ctc_fwd.launches, ctc_fwd.launches_segment, ctc_bwd.launches,
                      ctc_bwd.launches_segment)
    before = counts()
    ll_t, alphas_t, aout_t = ctc_fwd(tlp, tskip, ttl, tlab, t(alpha_in), seg * Tl)
    for got, want in ((ll_t, ll_j), (alphas_t, alphas_j), (aout_t, aout_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    grad_t, lpb_out_t = ctc_bwd(tlp, alphas_t, tskip, ttl, tlab, t(ll_global),
                                t(cot), t(lpb_in), seg * Tl)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), **GRAD)
    np.testing.assert_allclose(lpb_out_t.numpy(), np.asarray(lpb_out_j), **VAL)
    # on CPU tensors the wrappers are the plain loops: no launch is counted
    assert counts() == before


@functools.lru_cache(maxsize=None)
def _jax_reference(seq, data):
    """Summed loss, per-sequence losses and d sum / d logits of ``_batch``:
    JAX's sequence-sharded CTC on the segment kernels, and the single
    device."""
    logits, tl, labels, lab = _batch()
    mesh = j_make_mesh(data=data, model=1, seq=seq)
    args = (jnp.asarray(tl), jnp.asarray(labels), jnp.asarray(lab))

    def sharded(lg):
        per = j_ctc_loss_seq_sharded(mesh, lg, *args, data_sharded=data > 1, impl="pallas")
        return jnp.sum(per), per

    def single(lg):
        per = j_ctc_loss_per_seq(lg, *args, impl="xla")
        return jnp.sum(per), per

    return [jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits)) for f in (sharded, single)]


def _gather(out, data, seq):
    """The ranks' (losses, grad shard) laid out as the global batch."""
    losses = np.concatenate([out[d * seq][0].numpy() for d in range(data)])
    grad = np.concatenate([np.concatenate([out[d * seq + s][1].numpy() for s in range(seq)],
                                          axis=1) for d in range(data)])
    for d in range(data):   # every seq rank returns its rows' losses
        for s in range(seq):
            np.testing.assert_array_equal(out[d * seq + s][0].numpy(), out[d * seq][0].numpy())
    return losses, grad


@pytest.mark.parametrize("data,seq", [(1, 2), (1, 3), (1, 4), (2, 2)])
def test_ctc_loss_seq_sharded_matches_jax(data, seq):
    logits, tl, labels, lab = _batch()
    out = run_ranks(torch_rank_programs.ctc_value_and_grad, data * seq, "gloo", (data, seq),
                    logits, tl, labels, lab, timeout=TIMEOUT)
    losses, grad = _gather(out, data, seq)
    for ((v, per), g) in _jax_reference(seq, data):
        np.testing.assert_allclose(losses, np.asarray(per), **VAL)
        np.testing.assert_allclose(losses.sum(), float(v), rtol=1e-5)
        np.testing.assert_allclose(grad, np.asarray(g), **GRAD)


def test_one_seq_rank_equals_the_whole_sequence_loss():
    """On a mesh of one rank the chain is one segment at t_offset 0: the
    loss and gradient of ``ctc_loss_per_seq``."""
    logits, tl, labels, lab = _batch()
    mesh = make_mesh(device="cpu")
    x1 = torch.from_numpy(logits).requires_grad_(True)
    x2 = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_loss_seq_sharded(mesh, x1, tl, labels, lab)
    want = ctc_loss_per_seq(x2, torch.from_numpy(tl), torch.from_numpy(labels),
                            torch.from_numpy(lab))
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **VAL)
    g1, = torch.autograd.grad(got.sum(), x1)
    g2, = torch.autograd.grad(want.sum(), x2)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), **GRAD)


def test_ctc_loss_seq_sharded_argument_checks():
    logits, tl, labels, lab = _batch()
    mesh = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="label rows"):
        ctc_loss_seq_sharded(mesh, torch.from_numpy(logits[:2]), tl, labels, lab)

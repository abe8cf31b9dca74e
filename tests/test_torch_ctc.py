"""The port's CTC (ops/ctc.py, ops/ctc_scan.py) against the JAX package on
the CPU: the plain versions of the alpha and beta kernels (B1, B2) against
the Pallas kernels in interpret mode, segments included; ``ctc_scan``'s
loss and gradient through the log-softmax against ``jax.value_and_grad``
of the Pallas and the XLA recursions; variable lengths, label length 0, a
weighted cotangent, T longer than one TPU time chunk; the reference anchors.
Tolerance: rtol and atol 1e-5 for values, rtol 1e-4 and atol 1e-6 for
gradients, as tests/test_pallas_ctc.py (f32, the same recursion with sums
in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.ops.ctc import ctc_forward_logprob as j_ctc_forward_logprob
from wavenet_speech_tpu.ops.ctc import ctc_loss_per_seq as j_ctc_loss_per_seq
from wavenet_speech_tpu.ops.pallas.ctc import (NEG, _ctc_bwd_impl, _ctc_fwd_impl,
                                               ctc_forward_logprob_pallas)
from wavenet_speech_tpu_torch.ops import ctc as tctc
from wavenet_speech_tpu_torch.ops import ctc_scan
from wavenet_speech_tpu_torch.ops.ctc_scan import (ctc_bwd, ctc_bwd_ref, ctc_fwd,
                                                   ctc_fwd_ref, ctc_scan as t_ctc_scan)

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _rand(B=4, T=37, S=9, C=5, seed=0, zero_label=False):
    """Logits peaked on one likely alignment per sequence (each label on one
    frame, blanks between), as a trained model gives: |ll| stays under ~50.
    The f32 error of exp(alpha + beta - ll) grows with |ll|; on N(0, 1)
    logits at T=300 (|ll| ~ 360) the JAX package's own Pallas and XLA
    gradients differ by 1.5e-4, beyond the tolerance above."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, C, size=(B, S)).astype(np.int32)
    lab = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    if zero_label:
        lab[0] = 0
    tl = rng.integers(2 * S + 1, T + 1, size=(B,)).astype(np.int32)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    for b in range(B):
        path = np.zeros(T, np.int64)
        path[np.sort(rng.choice(tl[b], size=lab[b], replace=False))] = labels[b, :lab[b]]
        logits[b, np.arange(T), path] += 4.0
    return logits, tl, labels, lab


def _ext_inputs(logits, labels, blank=0):
    """(lp_ext_t (T, B, J), skipadd (B, J)) as numpy, made by the JAX
    package's own preamble."""
    from wavenet_speech_tpu.ops.ctc import _extend_labels, _gather_ext
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    ext, allow = _extend_labels(jnp.asarray(labels), blank)
    lp_ext_t = jnp.transpose(_gather_ext(lp, ext), (1, 0, 2))
    return np.asarray(lp_ext_t), np.asarray(jnp.where(allow, 0.0, NEG))


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


@pytest.mark.parametrize("case", ["full", "zero_label", "long", "segment"])
def test_fwd_bwd_ref_match_pallas_interpret(case):
    """ctc_fwd_ref / ctc_bwd_ref against _ctc_fwd_impl / _ctc_bwd_impl
    (interpret=True): alphas, ll, the carry out, and the gradient."""
    kw = dict(B=3, T=29, S=6)
    if case == "long":   # T over one TPU chunk (_pick_ct caps it at 128)
        kw = dict(B=2, T=300, S=20)
    logits, tl, labels, lab = _rand(seed=len(case), zero_label=case == "zero_label", **kw)
    lp, skip = _ext_inputs(logits, labels)
    T, B, J = lp.shape
    rng = np.random.default_rng(5)
    cot = rng.uniform(-2, 2, size=(B,)).astype(np.float32)
    seg = {}
    if case == "segment":
        # a later segment of a sharded sequence: a carried alpha, frame offset
        seg_alpha = np.where(rng.random((B, J)) < 0.5, NEG,
                             -rng.uniform(1, 20, (B, J))).astype(np.float32)
        seg_lpb = np.where(rng.random((B, J)) < 0.5, NEG,
                           -rng.uniform(1, 20, (B, J))).astype(np.float32)
        seg = dict(t_offset=7, tl_true=T - 3)
        tl = tl + 7
    ll_j, (lp_pad, alphas_j, aout_j) = _ctc_fwd_impl(
        jnp.asarray(lp), jnp.asarray(skip), jnp.asarray(tl), jnp.asarray(lab),
        interpret=True,
        **({} if not seg else dict(alpha_in=jnp.asarray(seg_alpha),
                                   t_offset=seg["t_offset"], tl_true=seg["tl_true"])))
    tlp, tskip, ttl, tlab = _t(lp, skip, tl, lab)
    ll_t, alphas_t, aout_t = ctc_fwd_ref(
        tlp, tskip, ttl, tlab,
        **({} if not seg else dict(alpha_in=torch.from_numpy(seg_alpha), **seg)))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), **VAL)
    np.testing.assert_allclose(alphas_t.numpy(), np.asarray(alphas_j)[:T], **VAL)
    np.testing.assert_allclose(aout_t.numpy(), np.asarray(aout_j), **VAL)

    g_j, bout_j = _ctc_bwd_impl(
        lp_pad, alphas_j, jnp.asarray(skip), jnp.asarray(tl), jnp.asarray(lab), ll_j,
        jnp.asarray(cot), T, interpret=True,
        **({} if not seg else dict(lpb_in=jnp.asarray(seg_lpb), **seg)))
    g_t, bout_t = ctc_bwd_ref(
        tlp, alphas_t, tskip, ttl, tlab, ll_t, torch.from_numpy(cot),
        **({} if not seg else dict(lpb_in=torch.from_numpy(seg_lpb), **seg)))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **GRAD)
    np.testing.assert_allclose(bout_t.numpy(), np.asarray(bout_j), **VAL)


@pytest.mark.parametrize("case", ["plain", "weighted", "zero_label", "long"])
def test_ctc_scan_value_and_grad_match_jax(case):
    """Loss and d loss / d logits through the log-softmax: the port's
    ctc_scan path against jax.value_and_grad of the Pallas path and of the
    XLA recursion."""
    kw = dict(B=2, T=300, S=20) if case == "long" else {}
    logits, tl, labels, lab = _rand(seed=3, zero_label=case == "zero_label", **kw)
    B = logits.shape[0]
    w = (np.linspace(-1.0, 2.0, B).astype(np.float32) if case == "weighted"
         else np.ones(B, np.float32))

    def j_loss(fn):
        def f(lg):
            lp = jax.nn.log_softmax(lg, axis=-1)
            return -jnp.sum(jnp.asarray(w) * fn(lp, jnp.asarray(tl), jnp.asarray(labels),
                                                 jnp.asarray(lab)))
        return jax.value_and_grad(f)(jnp.asarray(logits))

    x = torch.from_numpy(logits).requires_grad_(True)
    ll = ctc_scan.ctc_forward_logprob_kernel(torch.log_softmax(x, -1), torch.from_numpy(tl),
                                             torch.from_numpy(labels), torch.from_numpy(lab))
    v = -(torch.from_numpy(w) * ll).sum()
    v.backward()
    for fn in (ctc_forward_logprob_pallas, j_ctc_forward_logprob):
        vj, gj = j_loss(fn)
        np.testing.assert_allclose(float(v.detach()), float(vj), **VAL)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), **GRAD)


def test_plain_recursion_matches_jax_xla():
    """ops.ctc.ctc_forward_logprob (autograd through the frame loop) against
    the JAX XLA recursion, value and gradient."""
    logits, tl, labels, lab = _rand(seed=8, zero_label=True)
    x = torch.from_numpy(logits).requires_grad_(True)
    ll = tctc.ctc_forward_logprob(torch.log_softmax(x, -1), torch.from_numpy(tl),
                                  torch.from_numpy(labels), torch.from_numpy(lab))
    (-ll.sum()).backward()

    def f(lg):
        return -jnp.sum(j_ctc_forward_logprob(jax.nn.log_softmax(lg, -1), jnp.asarray(tl),
                                              jnp.asarray(labels), jnp.asarray(lab)))
    vj, gj = jax.value_and_grad(f)(jnp.asarray(logits))
    np.testing.assert_allclose(float(-ll.sum()), float(vj), **VAL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), **GRAD)


def test_ctc_loss_per_seq_matches_jax():
    logits, tl, labels, lab = _rand(seed=11)
    got = tctc.ctc_loss_per_seq(*_t(logits, tl, labels, lab))
    want = j_ctc_loss_per_seq(*(jnp.asarray(a) for a in (logits, tl, labels, lab)),
                              impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    np.testing.assert_allclose(float(tctc.ctc_loss(*_t(logits, tl, labels, lab))),
                               float(np.sum(np.asarray(want))), **VAL)


def test_known_answers():
    """The reference anchors 2.4628 (2-step) and 1.4519 (1-step), with the
    tolerances of tests/test_ctc_loss.py:16-30."""
    acts = torch.tensor([[[0.1, 0.6, 0.1, 0.1, 0.1], [0.1, 0.1, 0.6, 0.1, 0.1]]])
    v = tctc.ctc_loss(acts, torch.tensor([2]), torch.tensor([[1, 2]]), torch.tensor([2]))
    assert abs(float(v) - 2.4628) < 2e-3
    acts = torch.tensor([[[-10.0, -9.0, -8.0, -7.0, -6.0]]])
    v = tctc.ctc_loss(acts, torch.tensor([1]), torch.tensor([[3]]), torch.tensor([1]))
    assert abs(float(v) - 1.4519) < 5e-3


def test_extend_labels_and_densify_match_jax():
    from wavenet_speech_tpu.ops.ctc import _extend_labels, densify_labels
    labels = np.array([[1, 1, 2, 3], [4, 2, 2, 0]], np.int32)
    ext_j, allow_j = _extend_labels(jnp.asarray(labels), 0)
    ext_t, allow_t = tctc._extend_labels(torch.from_numpy(labels), 0)
    assert np.array_equal(ext_t.numpy(), np.asarray(ext_j))
    assert np.array_equal(allow_t.numpy(), np.asarray(allow_j))
    flat, lens = [1, 2, 3, 4, 4, 1], [2, 4, 0]
    assert np.array_equal(tctc.densify_labels(flat, lens, max_len=5),
                          densify_labels(flat, lens, max_len=5))


def test_wrappers_use_plain_versions_on_cpu():
    """On CPU tensors ctc_fwd/ctc_bwd are the plain versions and launch
    nothing; ctc_scan's autograd runs them."""
    logits, tl, labels, lab = _rand(seed=2)
    lp, skip = _ext_inputs(logits, labels)
    before = (ctc_fwd.launches, ctc_bwd.launches)
    tlp = torch.from_numpy(lp).requires_grad_(True)
    ll = t_ctc_scan(tlp, *_t(skip, tl, lab))
    ll.sum().backward()
    ll_ref, alphas, _ = ctc_fwd_ref(*_t(lp, skip, tl, lab))
    g_ref, _ = ctc_bwd_ref(*_t(lp), alphas, *_t(skip, tl, lab), ll_ref, torch.ones(len(tl)))
    assert torch.equal(ll.detach(), ll_ref) and torch.equal(tlp.grad, g_ref)
    assert (ctc_fwd.launches, ctc_bwd.launches) == before


@pytest.mark.parametrize("case", ["dtype", "states"])
def test_kernel_argument_checks(case):
    """The checks made before a launch (on CPU tensors here)."""
    lp = torch.zeros((4, 2, 9))
    if case == "dtype":
        lp = lp.double()
    else:
        lp = torch.zeros((1, 1, ctc_scan.MAX_STATES + 2))
    with pytest.raises(ValueError):
        ctc_scan._check("ctc_fwd", lp, torch.zeros(lp.shape[1:]))


@pytest.mark.parametrize("B", [8, 200])
@pytest.mark.parametrize("J", [3, 859, 1401, 8191, ctc_scan.MAX_STATES])
def test_kernel_launch_geometry(J, B):
    """The launch geometry of B1 (one ring row a frame) and B2 (two) on a
    132-SM card: C blocks a sequence (a cluster of at most 4) cover J with
    whole warps of runs of R states, plus the cluster edge's warp, within
    the kernel's thread limit (576 for runs of 8, else 1024); more than the
    fewest blocks only while every block has an SM of its own; the frame
    ring at least 2 frames deep and at most MAX_RING; the ring, the warp
    and cluster edges and the scratch within a block's shared memory on an
    H100 (csrc/ctc.cu ``smem_bytes``). At the bench shape (B=8, J=859):
    4 blocks of 215 states, one a thread, a ring of 16 frames."""
    for rings in (1, 2):
        R, C, threads, D = ctc_scan.ctc_geometry(J, rings, B, 132)
        warps = threads // 32 - 1
        assert R in ctc_scan.RUNS and C in ctc_scan.CLUSTERS and threads % 32 == 0
        assert threads <= (576 if R == 8 else 1024)
        Jc = 32 * R * warps
        assert C * Jc >= J > C * Jc - C * 32 * R
        assert C == 1 or B * C <= 132 or -(-J // (C // 2)) > ctc_scan.MAX_PART
        assert 2 <= D <= ctc_scan.MAX_RING
        smem = 16 * 32 + 4 * (rings * D * Jc + 4 * (warps + 1) + 2 * 32 + 36)
        assert smem <= ctc_scan.SMEM_LIMIT
    if (J, B) == (859, 8):
        assert ctc_scan.ctc_geometry(J, 2, B, 132) == (1, 4, 256, 16)

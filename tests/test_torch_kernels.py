"""The CUDA kernels against their plain versions, on the card only (marked
``cuda``; they skip without one). This file imports no jax, so it runs on
a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerances: the fused block sums f32 products in another order than
cuBLAS (rtol 1e-4, atol 1e-5 at these widths; its backward's weight
gradients sum over B*L frames, atol 1e-5 of the largest value); the CTC
kernels run the plain recursion's arithmetic (rtol 1e-5 for values, rtol
1e-4 and atol 1e-6 for the gradient); the beam must give equal live
prefixes, lengths and times, scores within 1e-3."""
import numpy as np
import pytest
import torch

from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (
    NEG_INF, beam_finalize, beam_search_kernel, beam_search_ref)
from wavenet_speech_tpu_torch.ops.ctc import NEG, _extend_labels, _gather_ext
from wavenet_speech_tpu_torch.ops.ctc_scan import (ctc_bwd, ctc_bwd_ref, ctc_fwd,
                                                   ctc_fwd_ref)
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block,
                                                      fused_gated_block_bwd,
                                                      fused_gated_block_bwd_ref,
                                                      fused_gated_block_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,L,C_in,C,K,d", [(2, 100, 32, 32, 2, 4),
                                            (1, 37, 8, 12, 3, 5),
                                            (2, 300, 64, 64, 2, 128),
                                            (3, 129, 260, 132, 2, 7)])
def test_fused_block_kernel_matches_plain(cuda, B, L, C_in, C, K, d):
    g = torch.Generator().manual_seed(d)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(cuda)
    args = (u(B, L, C_in), u(K, C_in, 2 * C) * 0.3, u(2 * C) * 0.1,
            u(C, 2 * C) * 0.3, u(2 * C) * 0.1, u(C_in, C) * 0.3, u(C) * 0.1)
    before = fused_gated_block.launches
    with torch.inference_mode():
        got = fused_gated_block(*args, d)
        want = fused_gated_block_ref(*args, d)
    torch.cuda.synchronize()
    assert fused_gated_block.launches == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,T,C,W,S,prune", [(2, 100, 5, 7, 64, None),
                                             (2, 60, 30, 8, 32, None),
                                             (1, 60, 30, 8, 32, 12),
                                             (2, 50, 5, 7, 5, None)])
def test_beam_kernel_matches_plain(cuda, B, T, C, W, S, prune):
    rng = np.random.default_rng(T + C)
    logits = (2 * rng.standard_normal((B, T, C))).astype(np.float32)
    logits[:, rng.random(T) < 0.6, 0] += 2
    lp = torch.log_softmax(torch.from_numpy(logits), -1).to(cuda)
    lengths = torch.tensor([T] + [T * 3 // 4] * (B - 1), device=cuda)
    kw = dict(beam_width=W, max_label_len=S, prune=prune)
    p1, l1, s1, t1 = (x.cpu() for x in beam_finalize(
        beam_search_kernel(lp, lengths, **kw)))
    p0, l0, s0, t0 = (x.cpu() for x in beam_finalize(
        beam_search_ref(lp, lengths, **kw)))
    for b in range(B):
        for r in range(W):
            if s0[b, r] <= NEG_INF / 2:
                break
            n = int(l0[b, r])
            assert int(l1[b, r]) == n
            assert abs(float(s1[b, r] - s0[b, r])) < 1e-3
            assert torch.equal(p1[b, r, :n], p0[b, r, :n])
            assert torch.equal(t1[b, r, :n], t0[b, r, :n])


@pytest.mark.parametrize("B,L,C_in,C,K,d", [(2, 100, 32, 32, 2, 4),
                                            (1, 37, 8, 12, 3, 5),
                                            (2, 700, 64, 64, 2, 512),
                                            (3, 129, 260, 132, 2, 7)])
def test_fused_block_bwd_kernel_matches_plain(cuda, B, L, C_in, C, K, d):
    g = torch.Generator().manual_seed(d + 1)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(cuda)
    x, gw, gb = u(B, L, C_in), u(K, C_in, 2 * C) * 0.3, u(2 * C) * 0.1
    ow, rw = u(C, 2 * C) * 0.3, u(C_in, C) * 0.3
    dr, ds = u(B, L, C), u(B, L, C)
    before = fused_gated_block_bwd.launches
    got = fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d)
    want = fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d)
    again = fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d)
    torch.cuda.synchronize()
    assert fused_gated_block_bwd.launches == before + 2
    for name, a, b, c in zip(("dx", "dWg", "dbg", "dWo", "dbo", "dWr", "dbr"),
                             got, want, again):
        assert torch.equal(a, c), f"{name}: two launches differ"  # deterministic
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(b.abs().max())),
                                   msg=lambda m: f"{name}: {m}")


def test_fused_block_autograd_matches_plain(cuda):
    """The autograd Function (B4 forward, B5 backward) against autograd of
    the plain version."""
    g = torch.Generator().manual_seed(3)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(cuda)
    args = [u(2, 200, 16), u(2, 16, 32) * 0.3, u(32) * 0.1, u(16, 32) * 0.3,
            u(32) * 0.1, u(16, 16) * 0.3, u(16) * 0.1]
    cots = u(2, 200, 16), u(2, 200, 16)
    grads = []
    for fn in (fused_gated_block, fused_gated_block_ref):
        leaves = [a.clone().requires_grad_(True) for a in args]
        r, s = fn(*leaves, 8)
        ((r * cots[0]).sum() + (s * cots[1]).sum()).backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(1.0, float(b.abs().max())))


def _ctc_inputs(cuda, B, T, S, C, seed):
    gen = np.random.default_rng(seed)
    logits = torch.from_numpy(gen.standard_normal((B, T, C)).astype(np.float32))
    labels = torch.from_numpy(gen.integers(1, C, size=(B, S)).astype(np.int32))
    lab = torch.from_numpy(gen.integers(0, S + 1, size=(B,)).astype(np.int32))
    lens = torch.from_numpy(gen.integers(1, T + 1, size=(B,)).astype(np.int32))
    ext, allow = _extend_labels(labels, 0)
    lp = _gather_ext(torch.log_softmax(logits, -1), ext).transpose(0, 1).contiguous()
    skip = torch.where(allow, 0.0, NEG)
    cot = torch.from_numpy(gen.uniform(-2, 2, size=(B,)).astype(np.float32))
    return [t.to(cuda) for t in (lp, skip, lens, lab, cot)]


@pytest.mark.parametrize("B,T,S,C,seg", [(3, 50, 6, 5, False),
                                         (8, 300, 429, 5, False),   # J = 859
                                         (2, 100, 700, 30, False),  # J = 1401 > 1024
                                         (2, 64, 10, 5, True)])
def test_ctc_kernels_match_plain(cuda, B, T, S, C, seg):
    lp, skip, lens, lab, cot = _ctc_inputs(cuda, B, T, S, C, T + S)
    J = lp.shape[2]
    kw = {}
    if seg:  # a later segment: carried state, frame offset, padded tail
        g = torch.Generator().manual_seed(1)
        carry = lambda: torch.where(torch.rand((B, J), generator=g) < 0.5, NEG,
                                    -20 * torch.rand((B, J), generator=g)).to(cuda)
        kw = dict(t_offset=9, tl_true=T - 5)
        lens = lens + 9
    before = (ctc_fwd.launches, ctc_bwd.launches)
    a_in = carry() if seg else None
    got = ctc_fwd(lp, skip, lens, lab, alpha_in=a_in, **kw)
    want = ctc_fwd_ref(lp, skip, lens, lab, alpha_in=a_in, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    b_in = carry() if seg else None
    gg = ctc_bwd(lp, want[1], skip, lens, lab, want[0], cot, lpb_in=b_in, **kw)
    gw = ctc_bwd_ref(lp, want[1], skip, lens, lab, want[0], cot, lpb_in=b_in, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(gg[0], gw[0], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gg[1], gw[1], rtol=1e-5, atol=1e-5)
    assert (ctc_fwd.launches, ctc_bwd.launches) == (before[0] + 1, before[1] + 1)

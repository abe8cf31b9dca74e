"""The CUDA kernels against their plain versions, on the card only (marked
``cuda``; they skip without one). This file imports no jax, so it runs on
a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

Tolerances: the fused block sums f32 products in another order than
cuBLAS (rtol 1e-4, atol 1e-5 at these widths; its backward's weight
gradients sum over B*L frames, atol 1e-5 of the largest value); the CTC
kernels run the plain recursion's arithmetic (rtol 1e-5 for values, rtol
1e-4 and atol 1e-6 for the gradient); the beam must give equal live
prefixes, lengths and times, scores within 1e-3. In bf16 the fused block's
kernels and plain versions round the same float32 sums, taken in another
order, to bf16: an output may be one bf16 step apart (2^-7 of its value),
plus the float32 term above; the forward also rounds act to bf16 before
the 1x1 product, where one flipped rounding moves an output by up to
2^-8 * |out_w| (two allowed). The multi-device cases run 2 gloo ranks on
the card (``parallel.run_ranks``): the seq-sharded decode's chain of B6
calls must give the bits of one call, and the gather of CUDA slices the
slices laid end to end. The multi-tensor guard and rules repeat PyTorch's
per-leaf arithmetic operation by operation (0 ulps; the guard's sums of
squares in another order, rtol 1e-5). The band attention's kernels run
float32-accurate split products (three TF32 products) and sum in another order than
the plain version's einsum and softmax: rtol 1e-4 and atol 1e-5 of the
largest value (outputs, the log-sum-exp and gradients are sums over at
most 256 keys or, for dk and dv, 256 queries)."""
from unittest import mock

import numpy as np
import pytest
import torch

import torch_rank_programs
from test_torch_beam_tree import PINNED_DUPLICATE, lp_numpy
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import ctc_beam_search
from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (
    NEG_INF, beam_finalize, beam_search_kernel, beam_search_ref)
from wavenet_speech_tpu_torch.ops.ctc import NEG, _extend_labels, _gather_ext
from wavenet_speech_tpu_torch.ops import multi_tensor, window_attention as wa
from wavenet_speech_tpu_torch.ops.ctc_scan import ctc_bwd, ctc_bwd_ref, ctc_fwd, ctc_fwd_ref
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block,
                                                      fused_gated_block_bwd,
                                                      fused_gated_block_bwd_ref,
                                                      fused_gated_block_kernel_ref,
                                                      fused_gated_block_ref)
from wavenet_speech_tpu_torch.parallel import run_ranks
from wavenet_speech_tpu_torch.training import TrainState, build_optimizer, trainer
from wavenet_speech_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# widths that are not multiples of 4 (zero-padded) and K > 8 taps
PADDED_SHAPES = [(2, 100, 6, 10, 3, 4), (2, 100, 6, 10, 9, 4)]
# the bench model's widths, L ragged against the 128-row tile (4505) and not
# (4608), the shortest and longest dilation
FULL_WIDTH = [(2, L, 256, 256, 2, d) for L in (4505, 4608) for d in (1, 512)]
# float32 forward widths past 256 (one warpgroup a block) and past 512 (act
# through device memory, two launches)
WIDE = [(2, 150, 40, 300, 2, 3), (2, 150, 40, 600, 3, 5)]


@pytest.mark.parametrize("B,L,C_in,C,K,d", [(2, 100, 32, 32, 2, 4),
                                            (1, 37, 8, 12, 3, 5),
                                            (2, 300, 64, 64, 2, 128),
                                            (3, 129, 260, 132, 2, 7),
                                            *PADDED_SHAPES, *FULL_WIDTH, *WIDE])
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


def _assert_beams_equal(got, want, W):
    """Raw beam states: live rows equal prefixes, lengths and times, scores
    within 1e-3."""
    p1, l1, s1, t1 = (x.cpu() for x in beam_finalize(got))
    p0, l0, s0, t0 = (x.cpu() for x in beam_finalize(want))
    for b in range(p0.shape[0]):
        for r in range(W):
            if s0[b, r] <= NEG_INF / 2:
                break
            n = int(l0[b, r])
            assert int(l1[b, r]) == n
            assert abs(float(s1[b, r] - s0[b, r])) < 1e-3
            assert torch.equal(p1[b, r, :n], p0[b, r, :n])
            assert torch.equal(t1[b, r, :n], t0[b, r, :n])


# long prefixes (T=1200, S=4608), W=32, B=1 and B=64, W=32 over 600
# frames, whose node pool does not fit in shared memory, and
# configs/gauss_quality.json's evaluate (B=6, T=S=488)
@pytest.mark.parametrize("B,T,C,W,S,prune", [(2, 100, 5, 7, 64, None),
                                             (2, 60, 30, 8, 32, None),
                                             (1, 60, 30, 8, 32, 12),
                                             (2, 50, 5, 7, 5, None),
                                             (2, 1200, 5, 7, 4608, None),
                                             (2, 100, 5, 32, 64, None),
                                             (1, 100, 5, 7, 64, None),
                                             (64, 100, 5, 7, 64, None),
                                             (1, 600, 5, 32, 64, None),
                                             (6, 488, 5, 7, 488, None)])  # gauss_quality
def test_beam_kernel_matches_plain(cuda, B, T, C, W, S, prune):
    rng = np.random.default_rng(T + C)
    logits = (2 * rng.standard_normal((B, T, C))).astype(np.float32)
    logits[:, rng.random(T) < 0.6, 0] += 2
    lp = torch.log_softmax(torch.from_numpy(logits), -1).to(cuda)
    lengths = torch.tensor([T] + [T * 3 // 4] * (B - 1), device=cuda)
    kw = dict(beam_width=W, max_label_len=S, prune=prune)
    before = beam_search_kernel.launches
    got = beam_search_kernel(lp, lengths, **kw)
    assert beam_search_kernel.launches == before + 1
    _assert_beams_equal(got, beam_search_ref(lp, lengths, **kw), W)


def test_beam_kernel_duplicate_nodes(cuda):
    """The inputs on which the CPU model of the kernel's tree meets parents
    held by different nodes of the same prefix
    (tests/test_torch_beam_tree.py)."""
    (B, T, C, seed), lengths, W, S, prune = PINNED_DUPLICATE
    lp = torch.from_numpy(lp_numpy(B, T, C, seed)).to(cuda)
    lengths = torch.tensor(lengths, device=cuda)
    kw = dict(beam_width=W, max_label_len=S, prune=prune)
    _assert_beams_equal(beam_search_kernel(lp, lengths, **kw),
                        beam_search_ref(lp, lengths, **kw), W)


@pytest.mark.parametrize("B,T,C,W,S,prune", [(2, 100, 5, 7, 64, None),
                                             (1, 60, 30, 8, 32, 12),
                                             (1, 1200, 5, 32, 64, None)])
def test_beam_kernel_chained_calls(cuda, B, T, C, W, S, prune):
    """Frames [0, T/2), then [T/2, T) from the state the first call
    returned: equal to one kernel call and to the plain chain."""
    lp = torch.from_numpy(lp_numpy(B, T, C, seed=T)).to(cuda)
    lengths = torch.tensor([T] + [T * 2 // 3] * (B - 1), device=cuda)
    kw = dict(beam_width=W, max_label_len=S, prune=prune)
    t1 = T // 2
    one = beam_search_kernel(lp, lengths, **kw)
    mid = beam_search_kernel(lp[:, :t1], lengths, **kw)
    two = beam_search_kernel(lp[:, t1:], lengths, state=mid, t0=t1, **kw)
    for x, y in zip(two, one):
        assert torch.equal(x, y)
    plain = beam_search_ref(lp[:, t1:], lengths, state=beam_search_ref(lp[:, :t1], lengths, **kw),
                            t0=t1, **kw)
    _assert_beams_equal(two, plain, W)


@pytest.mark.parametrize("B,L,C_in,C,K,d", [(2, 100, 32, 32, 2, 4),
                                            (1, 37, 8, 12, 3, 5),
                                            (2, 700, 64, 64, 2, 512),
                                            (3, 129, 260, 132, 2, 7),
                                            *PADDED_SHAPES, *FULL_WIDTH, *WIDE])
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


def test_fused_block_bwd_kernel_is_bit_equal_across_calls(cuda):
    """B5 at the bench shape: its fixed frame slices and in-order slice sum
    give the same bits on every call, in all seven outputs."""
    g = torch.Generator().manual_seed(11)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(cuda)
    B, L, C, K = 8, 4505, 256, 2
    args = (u(B, L, C), u(K, C, 2 * C) * 0.1, u(2 * C) * 0.1, u(C, 2 * C) * 0.1,
            u(C, C) * 0.1, u(B, L, C), u(B, L, C))
    first = fused_gated_block_bwd(*args, 64)
    for _ in range(2):
        again = fused_gated_block_bwd(*args, 64)
        for name, a, b in zip(("dx", "dWg", "dbg", "dWo", "dbo", "dWr", "dbr"), first, again):
            assert torch.equal(a, b), f"{name}: two calls differ"


@pytest.mark.parametrize("causal", [True, False])
def test_fused_block_autograd_matches_plain(cuda, causal):
    """The autograd Function (B4 forward, B5 backward) against autograd of
    the plain version, for a causal and a centred block."""
    g = torch.Generator().manual_seed(3)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(cuda)
    args = [u(2, 200, 16), u(2, 16, 32) * 0.3, u(32) * 0.1, u(16, 32) * 0.3,
            u(32) * 0.1, u(16, 16) * 0.3, u(16) * 0.1]
    cots = u(2, 200, 16), u(2, 200, 16)
    grads = []
    for fn in (fused_gated_block, fused_gated_block_ref):
        leaves = [a.clone().requires_grad_(True) for a in args]
        r, s = fn(*leaves, 8, causal)
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


# the ring's edges: T below the ring's depth, J = 3, the largest J, lengths
# ending mid-ring, a segment with tl_true < T at the bench's J (4 blocks a
# sequence), and one with no frame before tl_true (nothing crosses between
# the blocks)
@pytest.mark.parametrize("B,T,S,C,seg,lengths", [
    (3, 50, 6, 5, False, None),
    (8, 300, 429, 5, False, None),           # J = 859
    (2, 100, 700, 30, False, None),          # J = 1401 > 1024
    (2, 64, 10, 5, True, None),
    (3, 1, 6, 5, False, None),               # T = 1
    (3, 3, 6, 5, False, None),               # T = 3
    (4, 40, 1, 5, False, None),              # J = 3
    (2, 6, 4095, 30, False, None),           # J = 8191
    (4, 60, 20, 5, False, [60, 21, 9, 37]),  # lengths end mid-ring
    (8, 40, 429, 5, True, None),             # a segment at J = 859
    (8, 4, 429, 5, True, None),              # ... wholly past tl_true (T - 5 < 0)
    (6, 488, 89, 5, False, [488] * 6),       # gauss_quality's J = 179: one block a sequence
    (6, 488, 89, 5, False, [488, 470, 301, 488, 412, 450]),
    (4, 2048, 1030, 5, False, None)])          # the transformer cell's J = 2061, T = 2048
def test_ctc_kernels_match_plain(cuda, B, T, S, C, seg, lengths):
    lp, skip, lens, lab, cot = _ctc_inputs(cuda, B, T, S, C, T + S)
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    J = lp.shape[2]
    kw = {}
    if seg:  # a later segment: carried state, frame offset, padded tail
        g = torch.Generator().manual_seed(1)
        carry = lambda: torch.where(torch.rand((B, J), generator=g) < 0.5, NEG,
                                    -20 * torch.rand((B, J), generator=g)).to(cuda)
        kw = dict(t_offset=9, tl_true=T - 5)
        lens = lens + 9
    counts = lambda: (ctc_fwd.launches, ctc_bwd.launches, ctc_fwd.launches_segment,
                      ctc_bwd.launches_segment)
    before = counts()
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
    # a call with a carry is B3's: it counts apart
    whole, segment = (0, 1) if seg else (1, 0)
    assert counts() == (before[0] + whole, before[1] + whole, before[2] + segment,
                        before[3] + segment)


def test_ctc_segment_kernels_chain_to_the_whole_sequence(cuda):
    """B3: three segments chained by their carries equal B1/B2 on the whole
    sequence (sequences ending in the first and the middle segment); each
    call with a carry counts one launch_segment and no whole-sequence
    launch."""
    B, T, S, C = 4, 90, 8, 5
    lp, skip, lens, lab, cot = _ctc_inputs(cuda, B, T, S, C, T)
    lens = torch.tensor([T, 70, 40, 25], dtype=torch.int32, device=cuda)
    J = lp.shape[2]
    ll, alphas, _ = ctc_fwd_ref(lp, skip, lens, lab)
    grad, _ = ctc_bwd_ref(lp, alphas, skip, lens, lab, ll, cot)
    before = (ctc_fwd.launches, ctc_bwd.launches, ctc_fwd.launches_segment,
              ctc_bwd.launches_segment)
    alpha, seg_alphas, seg_ll = torch.full((B, J), NEG, device=cuda), [], None
    for s in range(3):
        seg_ll, a, alpha = ctc_fwd(lp[30 * s:30 * (s + 1)].contiguous(), skip, lens, lab,
                                   alpha, 30 * s)
        seg_alphas.append(a)
    torch.testing.assert_close(seg_ll, ll, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat(seg_alphas), alphas, rtol=1e-5, atol=1e-5)
    lpb, grads = torch.full((B, J), NEG, device=cuda), []
    for s in reversed(range(3)):
        g, lpb = ctc_bwd(lp[30 * s:30 * (s + 1)].contiguous(), seg_alphas[s], skip, lens,
                         lab, ll, cot, lpb, 30 * s)
        grads.insert(0, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat(grads), grad, rtol=1e-4, atol=1e-6)
    assert (ctc_fwd.launches, ctc_bwd.launches, ctc_fwd.launches_segment,
            ctc_bwd.launches_segment) == (before[0], before[1], before[2] + 3, before[3] + 3)


BF16_OUTPUTS = ("dx", "dWg", "dbg", "dWo", "dbo", "dWr", "dbr")


def _assert_bf16_close(got, want, atol, name):
    assert got.dtype == want.dtype == torch.bfloat16, name
    diff = (got.float() - want.float()).abs()
    bad = diff > 2.0 ** -7 * want.float().abs() + atol
    assert not bad.any(), (f"{name}: {int(bad.sum())} elements beyond tolerance, "
                           f"max_abs_err {float(diff.max()):.3e}")


def _bf16_block(cuda, seed, B, L, C_in, C, K):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(cuda)
    args = (u(B, L, C_in), u(K, C_in, 2 * C) * 0.3, u(2 * C) * 0.1,
            u(C, 2 * C) * 0.3, u(2 * C) * 0.1, u(C_in, C) * 0.3, u(C) * 0.1)
    return [a.to(torch.bfloat16) for a in args], u(B, L, C).to(torch.bfloat16), \
        u(B, L, C).to(torch.bfloat16)


def _fwd_atol(want, out_w):
    return 1e-5 * max(float(w.float().abs().max()) for w in want) + \
        2 * 2.0 ** -8 * float(out_w.float().abs().max())


# the bf16 kernels' shapes: small and padded widths (C=12, C_in=260 are not
# multiples of 8), full width at the shortest and longest dilation, and a
# ragged L shorter than the dilation (every tap but the last reads zeros)
BF16_SHAPES = [(2, 100, 32, 32, 2, 4), (1, 37, 8, 12, 3, 5), (2, 700, 64, 64, 2, 512),
               (3, 129, 260, 132, 2, 7), (1, 4505, 256, 256, 2, 1),
               (1, 4505, 256, 256, 2, 512), (2, 65, 256, 256, 2, 100), *PADDED_SHAPES]


@pytest.mark.parametrize("B,L,C_in,C,K,d", BF16_SHAPES)
def test_fused_block_bf16_kernel_matches_plain(cuda, B, L, C_in, C, K, d):
    args, _, _ = _bf16_block(cuda, d, B, L, C_in, C, K)
    before = (fused_gated_block.launches, fused_gated_block.launches_bf16)
    with torch.inference_mode():
        got = fused_gated_block(*args, d)
        want = fused_gated_block_ref(*args, d)
    torch.cuda.synchronize()
    assert (fused_gated_block.launches, fused_gated_block.launches_bf16) == \
        (before[0], before[1] + 1)
    for name, a, b in zip(("resid", "skip"), got, want):
        _assert_bf16_close(a, b, _fwd_atol(want, args[3]), name)


@pytest.mark.parametrize("B,L,C_in,C,K,d", BF16_SHAPES)
def test_fused_block_bwd_bf16_kernel_matches_plain(cuda, B, L, C_in, C, K, d):
    (x, gw, gb, ow, _, rw, _), dr, ds = _bf16_block(cuda, d + 1, B, L, C_in, C, K)
    before = (fused_gated_block_bwd.launches, fused_gated_block_bwd.launches_bf16)
    got = fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d)
    want = fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d)
    again = fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d)
    torch.cuda.synchronize()
    assert (fused_gated_block_bwd.launches, fused_gated_block_bwd.launches_bf16) == \
        (before[0], before[1] + 2)
    for name, a, b, c in zip(BF16_OUTPUTS, got, want, again):
        assert torch.equal(a, c), f"{name}: two launches differ"  # deterministic
        scale = float(b.float().abs().max())
        _assert_bf16_close(a, b, (1e-5 if name == "dx" else 1e-4) * scale, name)


def test_fused_block_bf16_autograd_matches_plain(cuda):
    """The autograd Function in bf16 (B4-bf16 forward, B5-bf16 backward)
    against the plain versions of both, on the same cotangents."""
    args, dr, ds = _bf16_block(cuda, 3, 2, 200, 16, 16, 2)
    leaves = [a.clone().requires_grad_(True) for a in args]
    r, s = fused_gated_block(*leaves, 8)
    torch.autograd.backward((r, s), (dr, ds))
    want = fused_gated_block_ref(*args, 8)
    for name, a, b in zip(("resid", "skip"), (r.detach(), s.detach()), want):
        _assert_bf16_close(a, b, _fwd_atol(want, args[3]), name)
    x, gw, gb, ow, _, rw, _ = args
    wantb = fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, 8)
    got = [t.grad for t in leaves]
    for name, i in zip(BF16_OUTPUTS, range(7)):
        scale = float(wantb[i].float().abs().max())
        _assert_bf16_close(got[i], wantb[i], (1e-5 if name == "dx" else 1e-4) * scale, name)


# centred blocks (causal=False): K 1-3 with spans (K-1) d odd and even, C_in
# != C, sequences shorter than the span (taps fall off both ends; at L=1 and
# L=4 every tap of a row, the last included, reads zeros), a width past 512
# (act through device memory); train.wavenet_ctc's classifier block (B=32,
# L=4505/4, d=32), and train.raw_ctcnet's widest-dilated block of 512 and its
# 2048-wide input block (B=24, L=569)
CENTRED_SHAPES = [(2, 100, 40, 32, 1, 1), (2, 100, 40, 32, 2, 1), (2, 100, 40, 32, 2, 2),
                  (1, 37, 8, 12, 3, 5), (2, 9, 64, 32, 3, 16), (2, 1, 32, 32, 2, 5),
                  (2, 4, 32, 32, 2, 16), (2, 150, 40, 600, 3, 5), (32, 1126, 256, 256, 2, 32),
                  (24, 569, 512, 512, 3, 16), (24, 569, 2048, 512, 2, 1)]


def _centred_block(cuda, seed, B, L, C_in, C, K, dtype):
    """A block's operands with kernels of variance 1/fan_in, as the models
    initialise them, so that outputs stay O(1) at every width; cotangents."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: (torch.rand(s, generator=g) * 2 - 1).to(cuda)
    k = lambda fan_in: 3.0 ** 0.5 / fan_in ** 0.5   # uniform(-1, 1) has variance 1/3
    args = (u(B, L, C_in), u(K, C_in, 2 * C) * k(K * C_in), u(2 * C) * 0.1,
            u(C, 2 * C) * k(C), u(2 * C) * 0.1, u(C_in, C) * k(C_in), u(C) * 0.1)
    return [a.to(dtype) for a in args], u(B, L, C).to(dtype), u(B, L, C).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,C_in,C,K,d", CENTRED_SHAPES)
def test_fused_block_centred_kernels_match_plain(cuda, B, L, C_in, C, K, d, dtype):
    """B4 and B5 (float32, or their bf16 forms) with the centred tap origin
    against the kernels' arithmetic in plain PyTorch with the centred pad
    (``fused_gated_block_kernel_ref``, ``fused_gated_block_bwd_ref``), at
    the causal tests' tolerances; the forward counts one centred launch, and
    two backward launches give the same bits."""
    args, dr, ds = _centred_block(cuda, 7 * d + K, B, L, C_in, C, K, dtype)
    before = (fused_gated_block.launches, fused_gated_block.launches_bf16,
              fused_gated_block.launches_centred)
    f32 = dtype == torch.float32
    with torch.inference_mode():
        got = fused_gated_block(*args, d, causal=False)
        want = fused_gated_block_kernel_ref(*args, d, causal=False)
    torch.cuda.synchronize()
    assert (fused_gated_block.launches, fused_gated_block.launches_bf16,
            fused_gated_block.launches_centred) == \
        (before[0] + f32, before[1] + (not f32), before[2] + 1)
    for name, a, b in zip(("resid", "skip"), got, want):
        if f32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=lambda m: f"{name}: {m}")
        else:
            _assert_bf16_close(a, b, _fwd_atol(want, args[3]), name)
    x, gw, gb, ow, _, rw, _ = args
    got = fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d, causal=False)
    want = fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d, causal=False)
    again = fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d, causal=False)
    torch.cuda.synchronize()
    for name, a, b, c in zip(BF16_OUTPUTS, got, want, again):
        assert torch.equal(a, c), f"{name}: two launches differ"  # deterministic
        scale = float(b.float().abs().max())
        if f32:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * max(1.0, scale),
                                       msg=lambda m: f"{name}: {m}")
        else:
            _assert_bf16_close(a, b, (1e-5 if name == "dx" else 1e-4) * scale, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_block_causal_launch_is_not_centred_and_repeats_bits(cuda, dtype):
    """A causal block (origin 0) at train.wavenet_ctc's shape counts no
    centred launch, and two runs of B4 and of B5 give the same bits."""
    B, L, C, K, d = 32, 1126, 256, 2, 32
    args, dr, ds = _centred_block(cuda, 5, B, L, C, C, K, dtype)
    x, gw, gb, ow, _, rw, _ = args
    before = fused_gated_block.launches_centred
    with torch.inference_mode():
        runs = [fused_gated_block(*args, d) for _ in range(2)]
    grads = [fused_gated_block_bwd(x, gw, gb, ow, rw, dr, ds, d) for _ in range(2)]
    torch.cuda.synchronize()
    assert fused_gated_block.launches_centred == before
    for a, b in zip(runs[0] + grads[0], runs[1] + grads[1]):
        assert torch.equal(a, b)


def test_seq_sharded_decode_chain_equals_one_call(cuda):
    """B6 on 2 seq ranks of the card, the beam state passed from the first
    to the second (host-staged over gloo): the bits of one B6 call."""
    g = torch.Generator().manual_seed(3)
    B, T, C, W, S = 4, 256, 5, 7, 128
    logits = 3.0 * torch.randn(B, T, C, generator=g)
    logits[..., 0] += 6.0 * (torch.rand(B, T, generator=g) < 0.7)
    lens = torch.tensor([T, T - 40, T - 128, 17], dtype=torch.int32)
    want = ctc_beam_search(logits.to(cuda), lens, beam_width=W, max_label_len=S,
                           return_times=True)
    out = run_ranks(torch_rank_programs.decoders, 2, "gloo", (1, 2), logits, lens, W, S,
                    "cuda", timeout=300.0)
    for rank in out:
        for got in (rank["seq"], rank["seq_data"]):
            for a, b in zip(got, want):
                assert torch.equal(a, b.cpu())


def test_gloo_gather_of_cuda_slices(cuda):
    """gather_axis over a "model" line of 2 gloo ranks on the card: each
    rank's slice of a CUDA tensor, laid end to end on every rank."""
    x = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8) - 20.5
    for dim in (0, 2):
        out = run_ranks(torch_rank_programs.gather_model, 2, "gloo", (1, 2, 1), x, dim, "cuda",
                        timeout=300.0)
        for got in out:
            assert torch.equal(got, x)


# ragged leaves: empty, one element, a chunk and one, several chunks, a
# strided (transposed) one
MT_SHAPES = [(0,), (1,), (16385,), (3, 20000), (129, 7), (5,)]


def _mt_lists(cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    lists = [[torch.randn(sh, generator=g, device=cuda) for sh in MT_SHAPES] for _ in range(4)]
    lists[0][4] = lists[0][4].t().contiguous().t()   # a strided gradient
    lists[2] = [x.abs() + 0.1 for x in lists[2]]
    return lists


def _as_plain():
    return mock.patch.object(multi_tensor, "_on_card", lambda xs: False)


@pytest.mark.parametrize("op", ["select", "scale", "add_scaled", "add", "rss", "rms", "adam",
                                "adamax"])
def test_multi_tensor_rules_match_plain(cuda, op):
    g, p, s, m = _mt_lists(cuda, 1)
    ok = torch.tensor(True, device=cuda)
    c1 = 1 - torch.pow(0.9, torch.tensor(4.0, device=cuda))
    c2 = 1 - torch.pow(0.999, torch.tensor(4.0, device=cuda))
    call = {"select": lambda f: f.select(ok, g) + f.select(~ok, g, p),
            "scale": lambda f: f.scale(g, -0.05) + f.scale(g, c1),
            "add_scaled": lambda f: f.add_scaled(g, p, 0.1),
            "add": lambda f: f.add(p, g),
            "rss": lambda f: sum(f.rss(g, s, 1e-7), []),
            "rms": lambda f: sum(f.rms(g, s, 0.9, 1e-8), []),
            "adam": lambda f: sum(f.adam(g, m, s, 0.9, 0.999, 1e-8, c1, c2), []),
            "adamax": lambda f: sum(f.adamax(g, m, s, 0.9, 0.999, 1e-8, c1), [])}[op]
    before = multi_tensor.launches
    got = call(multi_tensor)
    assert multi_tensor.launches > before
    with _as_plain():
        want = call(multi_tensor)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_contiguous()
        assert torch.equal(a, b), op


@pytest.mark.parametrize("case", ["finite", "nan", "inf", "1e19", "zeros"])
def test_multi_tensor_guard_matches_plain(cuda, case):
    g = _mt_lists(cuda, 2)[0][1:]   # the plain absmax takes no empty leaf
    if case in ("nan", "inf"):
        g[2][1, 7] = float("nan") if case == "nan" else float("inf")
    elif case == "1e19":
        g[1] *= 1e19
    elif case == "zeros":
        g = [torch.zeros_like(x) for x in g]
    tree = {"g": g}
    got = trainer.global_norm_safe(tree), trainer.all_finite(tree)
    with _as_plain():
        want = trainer.global_norm_safe(tree), trainer.all_finite(tree)
    assert bool(got[1]) == bool(want[1]) == (case not in ("nan", "inf"))
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0, equal_nan=True)
    assert torch.equal(multi_tensor.absmax(g).nan_to_num(-1.0),
                       multi_tensor.absmax_ref(g).nan_to_num(-1.0))


def test_multi_tensor_guarded_update_is_deterministic_and_plain(cuda):
    """Two guarded Adamax updates give the same bits, and the plain
    update's params and state."""
    g, p, _, _ = _mt_lists(cuda, 3)
    params, grads = {"p": p[1:]}, {"p": g[1:]}
    tx = build_optimizer("adamax", 2e-4, max_grad_norm=1.0)
    state = TrainState.create(params, tx)
    total = torch.tensor(2.0, device=cuda)
    run = lambda: trainer._guarded_update(state, total, grads, tx)
    one, two = run(), run()
    with _as_plain():
        plain = run()
    for a, b, c in zip(*(tree_leaves(x[:3]) for x in (one, two, plain))):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=0)


def test_multi_tensor_refuses_other_types(cuda):
    ok = torch.tensor(True, device=cuda)
    for bad in ([torch.ones(3, device=cuda, dtype=torch.float16)],
                [torch.ones(3, device=cuda), torch.ones(3)],
                [torch.ones(3, device=cuda, dtype=torch.float64)]):
        with pytest.raises(ValueError):
            multi_tensor.scale(bad, 2.0)
    with pytest.raises(ValueError):
        multi_tensor.select(ok, [torch.ones(3, device=cuda)], [torch.ones(4, device=cuda)])


def _band_inputs(cuda, B, T, H, dh, seed=0):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, T, 3, H, dh), generator=g).to(cuda)
    do = torch.randn((B, T, H, dh), generator=g).to(cuda)
    # q and k as the model hands them (dense); v a view into qkv, as there
    return qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2], do


def _close(got, want, name):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale, msg=name)


# the transformer's shape (B = 4 of its 32), T below the band and not a
# multiple of the 64-row tile, a one-sided band
@pytest.mark.parametrize("B,T,H,dh,window", [(4, 1024, 8, 64, (127, 128)),
                                             (2, 100, 2, 64, (127, 128)),
                                             (2, 333, 2, 64, (40, 0))])
def test_window_attention_kernels_match_plain(cuda, B, T, H, dh, window):
    q, k, v, do = _band_inputs(cuda, B, T, H, dh)
    before = wa.launches
    o, lse = wa.window_attention_fwd(q, k, v, window)
    o_ref, lse_ref = wa.window_attention_ref(q, k, v, window)
    _close(o, o_ref, "o")
    _close(lse, lse_ref, "lse")
    grads = wa.window_attention_bwd(q, k, v, o, lse, do, window)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o_ref = wa.window_attention_ref(*leaves, window)[0]
    want = torch.autograd.grad(o_ref, leaves, do)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        _close(a, b, name)
    assert wa.launches == before + 3


def test_window_attention_is_bit_equal_across_runs(cuda):
    """No atomics: two forwards and two backwards give the same bits."""
    q, k, v, do = _band_inputs(cuda, 4, 1024, 8, 64, seed=1)
    runs = []
    for _ in range(2):
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = wa.window_attention(*leaves, (127, 128))
        runs.append([o.detach(), *torch.autograd.grad(o, leaves, do)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _onehot_batch(rng, B, lo, hi, levels):
    """B one-hot reads of lo..hi levels (the first of hi), zero past each
    read's length."""
    lens = rng.integers(lo, hi + 1, size=B).astype(np.int32)
    lens[0] = hi
    lv = rng.integers(0, levels, size=(B, int(lens.max())))
    x = np.zeros(lv.shape + (levels,), np.float32)
    b, t = np.nonzero(np.arange(lv.shape[1])[None, :] < lens[:, None])
    x[b, t, lv[b, t]] = 1.0
    return x, lens


def test_basecaller_staging_matches_the_plain_copy(cuda):
    """Basecaller.__call__'s pinned staging buffer and queued copies hand
    the model the bits of the plain route (``np.pad`` into a new array,
    then ``.to(device)``): over long, short and long calls of 16 reads of
    3,000-6,000 one-hot samples of 256 levels, bucket 128, the logits are
    equal bit for bit, and so are the strings and scores; the buffer is
    pinned and allocated once."""
    from wavenet_speech_tpu_torch.facade import Model
    from wavenet_speech_tpu_torch.inference import Basecaller

    class PlainCopy(Basecaller):
        def _stage_to_device(self, raw, Lp):
            return torch.from_numpy(np.pad(raw, ((0, 0), (0, Lp - raw.shape[1]), (0, 0)))
                                    ).to(self.device)

    cfg = {"model": {"base": {"signal_dim": 256, "entry_kwidth": 2, "kernel": 2,
                              "dilations": [2 ** i for i in range(10)]},
                     "classifier": {"kernel": 2, "dilations": [2 ** i for i in range(6)],
                                    "downsample": 4, "num_labels": 5}}}
    model = Model("wavenet-ctc", cfg, device=cuda).init(0)
    kw = dict(beam_width=7, pad_to_multiple=128, logit_length_fn=model.output_length,
              device=cuda)
    staged, plain = Basecaller(model, **kw), PlainCopy(model, **kw)
    logits = []
    model.register_forward_hook(lambda mod, args, out: logits.append(out))
    rng = np.random.default_rng(0)
    for lo, hi in [(3000, 6000), (3000, 3500), (3000, 6000)]:
        sig, lens = _onehot_batch(rng, 16, lo, hi, 256)
        got = staged(sig, lens)
        want = plain(sig, lens)
        assert torch.isfinite(logits[-1]).all()
        assert torch.equal(logits[-2], logits[-1])
        assert got == want
    assert staged._stage.is_pinned()
    assert (staged.staged_calls, staged.staging_allocs) == (3, 1)

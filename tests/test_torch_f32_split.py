"""The numerics of the float32 fused block kernels, emulated in PyTorch on
the CPU at a small size (B=2, L=100, C=32, d=4; K=2 and K=9).

B4 (csrc/fused_block.cu) and B5 (csrc/fused_block_bwd.cu) take every
float32 product on the tensor cores as three TF32 products over the split
v = hi + lo, hi = tf32(v), lo = tf32(v - hi) (cvt.rna: round to nearest,
ties away from zero, to 10 mantissa bits): hi lo + lo hi, then hi hi,
summed in float32; the lo lo term is dropped. The emulation does the same with torch
ops: TF32 rounding by integer operations on the float32 bits, and float32
matmuls of TF32 values, whose products are exact in float32. It is held to
chip_smoke's float32 tolerances against the plain versions
``fused_gated_block_ref`` and ``fused_gated_block_bwd_ref``:
|got - want| <= 1e-4 |want| + atol max|want| (atol 1e-5 for the forward's
outputs and dx, 1e-4 for the weight and bias gradients). The control takes
one TF32 pass (hi hi only): it exceeds the same bound (observed 1.7-41x),
so the split is what keeps the kernels within it. The split itself stays
within a tenth of the bound (observed <= 0.034 of it)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wavenet_speech_tpu_torch.ops import fused_block as fb

RTOL, ATOL, WGRAD_ATOL = 1e-4, 1e-5, 1e-4  # chip_smoke's B4_RTOL, B4_ATOL, B5_WGRAD_ATOL
NAMES = ("dx", "dWg", "dbg", "dWo", "dbo", "dWr", "dbr")


def tf32(v):
    """cvt.rna.tf32.f32: v rounded to 10 mantissa bits, ties away from zero
    (in sign-magnitude bits, adding half an ulp rounds the magnitude)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_mm(a, b):
    """a @ b as the kernels take it: three TF32 products summed in float32,
    the cross terms first, then hi hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (ah @ bl + al @ bh) + ah @ bh


def single_mm(a, b):
    """The control: one TF32 pass."""
    return tf32(a) @ tf32(b)


def fwd_emulated(x, gw, gb, ow, ob, rw, rb, d, mm):
    """B4's arithmetic: the gate, act in float32, the 1x1 and the residual
    projection into one accumulator, then the biases."""
    K, L, C = gw.shape[0], x.shape[1], rw.shape[1]
    xp = F.pad(x, (0, 0, (K - 1) * d, 0))
    g = sum(mm(xp[:, j * d: j * d + L], gw[j]) for j in range(K)) + gb
    act = torch.tanh(g[..., :C]) * torch.sigmoid(g[..., C:])
    o = mm(act, ow)
    resid = (o[..., :C] + mm(x, rw) + ob[:C]) + rb
    return resid, o[..., C:] + ob[C:]


def bwd_emulated(x, gw, gb, ow, rw, dr, ds, d, mm):
    """B5's arithmetic: da, the gate recompute, dg and act in float32, dx,
    the weight gradients as products over the frames, the bias sums."""
    K, _, C2 = gw.shape
    C = C2 // 2
    B, L, _ = x.shape
    h = (K - 1) * d
    xp = F.pad(x, (0, 0, h, 0))
    taps = [xp[:, j * d: j * d + L] for j in range(K)]
    g = sum(mm(taps[j], gw[j]) for j in range(K)) + gb
    th, sg = torch.tanh(g[..., :C]), torch.sigmoid(g[..., C:])
    do = torch.cat([dr, ds], -1)
    da = mm(do, ow.T)
    dg = torch.cat([da * sg * (1 - th * th), da * th * sg * (1 - sg)], -1)
    dgp = F.pad(dg, (0, 0, 0, h))
    dx = sum(mm(dgp[:, (K - 1 - j) * d:(K - 1 - j) * d + L], gw[j].T) for j in range(K))
    dx = dx + mm(dr, rw.T)
    rows = lambda t: t.reshape(B * L, -1)
    dwg = torch.stack([mm(rows(taps[j]).T, rows(dg)) for j in range(K)])
    return (dx, dwg, dg.sum((0, 1)), mm(rows(th * sg).T, rows(do)), do.sum((0, 1)),
            mm(rows(x).T, rows(dr)), dr.sum((0, 1)))


def _inputs(seed, B=2, L=100, C=32, K=2):
    rng = np.random.default_rng(seed)
    u = lambda *s, scale=1.0: torch.from_numpy((rng.uniform(-1, 1, s) * scale).astype(np.float32))
    return (u(B, L, C), u(K, C, 2 * C, scale=0.3), u(2 * C, scale=0.1), u(C, 2 * C, scale=0.3),
            u(2 * C, scale=0.1), u(C, C, scale=0.3), u(C, scale=0.1), u(B, L, C), u(B, L, C))


def _ratio(got, want, atol):
    """max |got - want| / (RTOL |want| + atol max|want|): <= 1 is within."""
    bound = RTOL * want.abs() + atol * float(want.abs().max()) + 1e-30
    return float(((got - want).abs() / bound).max())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    v = (rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))).astype(np.float32)
    m, e = np.frexp(v.astype(np.float64))  # |m| in [0.5, 1): 11 bits kept
    scaled = np.ldexp(np.abs(m), 11)
    want = np.sign(m) * np.ldexp(np.floor(scaled + 0.5), e - 11)  # ties away from zero
    got = tf32(torch.from_numpy(v)).numpy().astype(np.float64)
    np.testing.assert_array_equal(got, want)
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11])
    assert tf32(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2 * 2.0 ** -10]


def test_split_parts_are_tf32_and_carry_v():
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(10000).astype(np.float32))
    hi = tf32(v)
    lo = tf32(v - hi)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # v - hi is exact; hi + lo carries v to ~2^-22 of it
    assert float(((hi + lo - v).abs() / v.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("K", [2, 9])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_split_within_f32_tolerance(seed, K):
    x, gw, gb, ow, ob, rw, rb, _, _ = _inputs(seed, K=K)
    d = 4
    want = fb.fused_gated_block_ref(x, gw, gb, ow, ob, rw, rb, d)
    split = fwd_emulated(x, gw, gb, ow, ob, rw, rb, d, split_mm)
    once = fwd_emulated(x, gw, gb, ow, ob, rw, rb, d, single_mm)
    for name, s, w in zip(("resid", "skip"), split, want):
        assert _ratio(s, w, ATOL) <= 0.1, name
    assert max(_ratio(o, w, ATOL) for o, w in zip(once, want)) > 1.0  # the control


@pytest.mark.parametrize("K", [2, 9])
@pytest.mark.parametrize("seed", [0, 1])
def test_backward_split_within_f32_tolerance(seed, K):
    x, gw, gb, ow, _, rw, _, dr, ds = _inputs(seed, K=K)
    d = 4
    want = fb.fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d)
    split = bwd_emulated(x, gw, gb, ow, rw, dr, ds, d, split_mm)
    once = bwd_emulated(x, gw, gb, ow, rw, dr, ds, d, single_mm)
    for name, s, w in zip(NAMES, split, want):
        assert _ratio(s, w, ATOL if name == "dx" else WGRAD_ATOL) <= 0.1, name
    assert _ratio(once[0], want[0], ATOL) > 1.0  # the control: dx leaves the bound

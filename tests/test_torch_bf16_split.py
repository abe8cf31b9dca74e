"""The numerics of the bf16 fused block kernels, emulated in PyTorch on the
CPU at a small size (B=2, L=100, C=32, K=2, d=4).

B5-bf16 (csrc/fused_block_bwd_bf16.cu) keeps dg and act float32, as the
TPU kernel's arithmetic does, and takes each product with one of them (dx's
dg Wg^T, dWg = x^T dg, dWo = act^T do) as two bf16 products over the split
v = hi + lo, hi = bf16(v), lo = bf16(v - hi), both summed in float32. The
emulation here does the same with torch ops: bf16 values are exact in
float32, and so are their products. It is held to chip_smoke's bf16
tolerance of the plain version ``fused_gated_block_bwd_ref``:
|got - want| <= 2^-7 |want| + atol max|want| (atol 1e-5 for dx, 1e-4 for
the weight and bias gradients). Margin: before the final rounding to bf16,
the split's float32 results stay within a quarter of half that tolerance
(2^-8 |want| + atol max|want|; observed <= 0.12 of it), so only a flipped
bf16 rounding of the output can approach the tolerance. The control rounds
dg and act once to bf16 instead: it exceeds the same bound (observed
6-80x), so the split is what keeps the kernel within it.

Also: the channel zero-padding the bf16 wrappers apply to widths that are
not multiples of 8 changes no result of the plain versions."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wavenet_speech_tpu_torch.ops import fused_block as fb

BF = torch.bfloat16
NAMES = ("dx", "dWg", "dbg", "dWo", "dbo", "dWr", "dbr")


def _split(v):
    hi = v.to(BF).float()
    return hi, (v - hi).to(BF).float()


def _once(v):
    return v.to(BF).float(), torch.zeros_like(v)


def _bwd_emulated(x, gw, gb, ow, rw, dr, ds, d, split):
    """The backward as B5-bf16 computes it, before its final rounding:
    bf16 inputs widened, dg and act through `split`, float32 sums."""
    x, gw, gb, ow, rw, dr, ds = (t.float() for t in (x, gw, gb, ow, rw, dr, ds))
    K, _, C2 = gw.shape
    C = C2 // 2
    B, L, _ = x.shape
    h = (K - 1) * d
    xp = F.pad(x, (0, 0, h, 0))
    taps = [xp[:, j * d: j * d + L] for j in range(K)]
    g = gb + sum(taps[j] @ gw[j] for j in range(K))
    th, sg = torch.tanh(g[..., :C]), torch.sigmoid(g[..., C:])
    do = torch.cat([dr, ds], -1)
    da = do @ ow.T
    (g_hi, g_lo), (a_hi, a_lo) = split(torch.cat(
        [da * sg * (1 - th * th), da * th * sg * (1 - sg)], -1)), split(th * sg)
    dx = dr @ rw.T
    for j in range(K):
        s = (K - 1 - j) * d
        for plane in (g_hi, g_lo):
            dx = dx + F.pad(plane, (0, 0, 0, h))[:, s:s + L] @ gw[j].T
    rows = lambda t: t.reshape(B * L, -1)
    dwg = torch.stack([rows(taps[j]).T @ rows(g_hi) + rows(taps[j]).T @ rows(g_lo)
                       for j in range(K)])
    return (dx, dwg, (g_hi + g_lo).sum((0, 1)),
            rows(a_hi).T @ rows(do) + rows(a_lo).T @ rows(do), do.sum((0, 1)),
            rows(x).T @ rows(dr), dr.sum((0, 1)))


def _inputs(seed, B=2, L=100, C=32, K=2):
    rng = np.random.default_rng(seed)
    u = lambda *s, scale=1.0: torch.from_numpy(
        (rng.uniform(-1, 1, s) * scale).astype(np.float32)).to(BF)
    return (u(B, L, C), u(K, C, 2 * C, scale=0.3), u(2 * C, scale=0.1),
            u(C, 2 * C, scale=0.3), u(C, C, scale=0.3), u(B, L, C), u(B, L, C))


def _ratio(got, want, name, step):
    """max |got - want| / (step |want| + atol max|want|)."""
    got, want = got.float(), want.float()
    atol = (1e-5 if name == "dx" else 1e-4) * float(want.abs().max())
    return float(((got - want).abs() / (step * want.abs() + atol + 1e-30)).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_lo_split_within_bf16_tolerance(seed):
    args, d = _inputs(seed), 4
    want_bf16 = fb.fused_gated_block_bwd_ref(*args, d)
    want_f32 = fb.fused_gated_block_bwd_ref(*(t.float() for t in args), d)
    split = _bwd_emulated(*args, d, _split)
    once = _bwd_emulated(*args, d, _once)
    for name, s, w16, w32 in zip(NAMES, split, want_bf16, want_f32):
        assert _ratio(s.to(BF), w16, name, 2.0 ** -7) <= 1.0, name
        assert _ratio(s, w32, name, 2.0 ** -8) <= 0.25, name
    # control: one rounding of dg and act leaves dx far outside the bound
    assert _ratio(once[0], want_f32[0], "dx", 2.0 ** -8) > 1.0


@pytest.mark.parametrize("B,L,C_in,C,K,d", [(2, 37, 260, 12, 3, 5), (1, 50, 20, 16, 2, 7)])
def test_bf16_channel_padding_changes_nothing(B, L, C_in, C, K, d):
    g = torch.Generator().manual_seed(C_in)
    u = lambda *s: torch.rand(s, generator=g) * 2 - 1
    x, gw, gb, ow, ob, rw, rb = (u(B, L, C_in), u(K, C_in, 2 * C), u(2 * C), u(C, 2 * C),
                                 u(2 * C), u(C_in, C), u(C))
    dr, ds = u(B, L, C), u(B, L, C)
    (xp, gwp, gbp, owp, rwp, drp, dsp, obp, rbp), Ci, Cp = fb._pad_widths(
        fb.BF16_ALIGN, C_in, C, x, gw, gb, ow, rw, (dr, ds), out_b=ob, res_b=rb)
    assert (Ci % fb.BF16_ALIGN, Cp % fb.BF16_ALIGN) == (0, 0)
    for got, want in zip(fb.fused_gated_block_ref(xp, gwp, gbp, owp, obp, rwp, rbp, d),
                         fb.fused_gated_block_ref(x, gw, gb, ow, ob, rw, rb, d)):
        assert int(torch.count_nonzero(got[..., C:])) == 0
        torch.testing.assert_close(got[..., :C], want, rtol=1e-6, atol=1e-6)
    got = fb._unpad_grads(fb.fused_gated_block_bwd_ref(xp, gwp, gbp, owp, rwp, drp, dsp, d),
                          C_in, C, Cp)
    for name, a, b in zip(NAMES, got, fb.fused_gated_block_bwd_ref(x, gw, gb, ow, rw, dr, ds, d)):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)

"""The port's fused gated block (plain version, and ResidualBlock both
causal and non-causal) against the JAX package on the CPU. There the JAX
``fused_gated_block`` runs its own composite, as tests/test_pallas_block.py
runs it. Tolerance: rtol 1e-5, atol 1e-6 (f32, the same sums in another
order). The centred plain version (``causal=False``) is the composite the
non-causal ResidualBlock ran before it took the fused path, bit for bit. The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.models.blocks import ResidualBlock as JBlock
from wavenet_speech_tpu.ops.pallas.residual_block import (_xla_reference,
                                                          fused_gated_block as jfused)
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.models.blocks import ResidualBlock
from wavenet_speech_tpu_torch.ops import fused_block
from wavenet_speech_tpu_torch.ops.activations import gated_activation
from wavenet_speech_tpu_torch.ops.conv import noncausal_conv1d
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block,
                                                      fused_gated_block_kernel_ref,
                                                      fused_gated_block_ref)

TOL = dict(rtol=1e-5, atol=1e-6)
# bf16 results: the same float32 values up to the order of their sums, each
# rounded to bf16, one bf16 step (2^-7 relative) apart at most
BF16_STEP = 2.0 ** -7


def _args(seed, B=2, L=61, C_in=12, C=8, K=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    return (f(B, L, C_in), f(K, C_in, 2 * C) * 0.4, f(2 * C) * 0.1,
            f(C, 2 * C) * 0.4, f(2 * C) * 0.1, f(C_in, C) * 0.4, f(C) * 0.1)


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("d", [1, 4, 16])
def test_fused_block_ref_matches_jax(d, K):
    a = _args(d * 7 + K, K=K)
    ta = [torch.from_numpy(v) for v in a]
    ja = [jnp.asarray(v) for v in a]
    r, s = fused_gated_block_ref(*ta, d)
    r_x, s_x = _xla_reference(*ja, dilation=d)
    r_f, s_f = jfused(*ja, d)
    for got, want in ((r, r_x), (s, s_x), (r, r_f), (s, s_f)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = fused_gated_block.launches
    r2, s2 = fused_gated_block(*ta, d)
    assert torch.equal(r2, r) and torch.equal(s2, s)
    assert fused_gated_block.launches == before


def composite_block(x, gate_w, gate_b, out_w, out_b, res_w, res_b, dilation):
    """The centred block as ResidualBlock's composite computed it:
    ``noncausal_conv1d``, the gated activation, the 1x1s."""
    C = res_w.shape[1]
    g = noncausal_conv1d(x, gate_w, gate_b, dilation=dilation)
    act = gated_activation(g[..., :C], g[..., C:])
    o = act @ out_w + out_b
    return o[..., :C] + (x @ res_w + res_b), o[..., C:]


def centred_length(K, d, length):
    """A sequence long enough that every tap meets it, or shorter than the
    taps' span (K-1) d, so that taps fall off both ends."""
    return 37 if length == "long" else max(1, (K - 1) * d - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", ["long", "short"])
@pytest.mark.parametrize("d", [1, 2, 5, 16])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_centred_ref_matches_composite(K, d, length, dtype):
    """The plain version with the centred pad (``causal=False``) gives the
    composite's bits, in float32 and in bf16 (C_in=12 != C=8, taps off both
    ends of the short sequences). On a CPU tensor the wrapper is the plain
    version and launches nothing."""
    a = [torch.from_numpy(v).to(dtype)
         for v in _args(100 * K + d, L=centred_length(K, d, length), K=K)]
    got = fused_gated_block_ref(*a, d, causal=False)
    want = composite_block(*a, d)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (2, centred_length(K, d, length), 8)
        assert torch.equal(g, w)
    before = (fused_gated_block.launches, fused_gated_block.launches_centred)
    again = fused_gated_block(*a, d, causal=False)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    assert (fused_gated_block.launches, fused_gated_block.launches_centred) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("length", ["long", "short"])
@pytest.mark.parametrize("d", [1, 2, 5, 16])
@pytest.mark.parametrize("K", [1, 2, 3])
def test_centred_kernel_ref_matches_composite(K, d, length, dtype):
    """The kernels' arithmetic with the centred tap origin (K shifted
    matmuls, which the card's kernels are held to) computes the composite:
    in float32 within TOL; in bf16, with act rounded before the 1x1 and the
    outputs rounded, within two bf16 steps of the largest value of the
    composite on the widened operands (as the causal bf16 form is held to
    JAX's composite in tests/test_torch_bf16.py)."""
    L = centred_length(K, d, length)
    a = [torch.from_numpy(v).to(dtype) for v in _args(100 * K + d, L=L, K=K)]
    got = fused_gated_block_kernel_ref(*a, d, causal=False)
    want = composite_block(*(t.float() for t in a), d)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (2, L, 8)
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, **TOL)
        else:
            assert float((g.float() - w).abs().max()) < 2 * BF16_STEP * float(w.abs().max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [1, 4, 16])
def test_residual_block_matches_jax(causal, d):
    jblk = JBlock(12, 8, 2, d, causal=causal)
    params = jblk.init(jax.random.PRNGKey(d))
    tblk = ResidualBlock(12, 8, 2, d, causal=causal, device="cpu")
    tblk.load_state_dict(bridge._block(
        jax.tree_util.tree_map(np.asarray, params), ""))
    x = np.random.default_rng(d).standard_normal((2, 50, 12)).astype(np.float32)
    with torch.no_grad():
        r, s = tblk(torch.from_numpy(x))
    r_j, s_j = jblk.apply(params, jnp.asarray(x))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    assert tblk.receptive_field == jblk.receptive_field


def _cpu_args():
    return [torch.from_numpy(v) for v in _args(0, C_in=8, C=8)]


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguous", "divisible",
                                  "dilation", "rank", "out_w", "res_w"])
def test_kernel_argument_checks(case):
    """The checks the wrapper makes before a launch (run on CPU tensors
    here; the launch itself needs the card). Every case but ``divisible``
    raises; C_in=6 is accepted and padded to the kernels' multiple of 32."""
    a = _cpu_args()
    d = 2
    if case == "dtype":
        a[0] = a[0].double()
    elif case == "shape":
        a[2] = a[2][:-1]
    elif case == "contiguous":
        a[5] = a[5].t().contiguous().t()
    elif case == "divisible":
        # widths the kernels do not take are accepted and zero-padded
        a = [torch.from_numpy(v) for v in _args(0, C_in=6, C=8)]
        assert fused_block._check_args(*a, d) == (2, 61, 6, 8, 2)
        padded, Ci, Cp = fused_block._pad_widths(fused_block.F32_ALIGN, 6, 8, *a[:4],
                                                 a[5], out_b=a[4], res_b=a[6])
        assert (Ci, Cp) == (32, 32) and padded[0].shape == (2, 61, 32)
        return
    elif case == "dilation":
        d = 0
    elif case == "rank":
        a[0] = a[0][0]
    elif case == "out_w":
        a[3] = a[3][:, :-4].contiguous()
    else:
        a[5] = a[5][:-4]
    with pytest.raises((ValueError, RuntimeError)):
        fused_block._check_args(*a, d)


def test_kernel_argument_checks_accept_main_path_layout():
    assert fused_block._check_args(*_cpu_args(), 3) == (2, 61, 8, 8, 2)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_accepts_grad_tensors(monkeypatch, causal):
    """The CUDA path is an autograd Function (B4 forward, B5 backward); its
    forward checks its tensors, which require grad there. Run on the CPU
    with the launches replaced by the plain versions: the checks accept the
    tensors, the block's kind reaches both launches, and the Function's
    gradients equal autograd of the plain version."""
    seen = []

    def launch_fwd(*a):
        seen.append(fused_block._check_args(*a[:8]))
        assert a[8] is causal
        return fused_block.fused_gated_block_ref(*a)

    monkeypatch.setattr(fused_block, "_launch_fwd", launch_fwd)
    def launch_bwd(*a):
        assert a[8] is causal
        return fused_block.fused_gated_block_bwd_ref(*a)

    monkeypatch.setattr(fused_block, "fused_gated_block_bwd", launch_bwd)
    a = _cpu_args()
    cots = [torch.randn(2, 61, 8, generator=torch.Generator().manual_seed(i))
            for i in range(2)]
    grads = []
    for fn in (fused_block._FusedGatedBlock.apply, fused_gated_block_ref):
        leaves = [t.clone().requires_grad_(True) for t in a]
        r, s = fn(*leaves, 3, causal)
        ((r * cots[0]).sum() + (s * cots[1]).sum()).backward()
        grads.append([t.grad for t in leaves])
    assert seen == [(2, 61, 8, 8, 2)]
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("align", ["F32_ALIGN", "BF16_ALIGN"])
def test_padded_forward_matches_unpadded(monkeypatch, align):
    """The CUDA path's zero-padding of the widths, end to end on the CPU:
    C_in=6, C=10, K=9 padded to the kernels' multiple, the plain version in
    place of the float32 kernel, the outputs cut back; equal to the plain
    version at the unpadded widths within 1e-6 relative (zero channels add
    only zero products, which BLAS may sum in another order)."""
    monkeypatch.setattr(fused_block, "F32_ALIGN", getattr(fused_block, align))
    seen = []

    def kernel(*a):
        seen.append((a[0].shape[-1], a[5].shape[-1]))
        return fused_gated_block_ref(*a)

    monkeypatch.setattr(fused_block, "_fwd_f32", kernel)
    a = [torch.from_numpy(v) for v in _args(5, C_in=6, C=10, K=9)]
    got = fused_block._launch_fwd(*a, 3)
    want = fused_gated_block_ref(*a, 3)
    assert seen == [(32, 32) if align == "F32_ALIGN" else (8, 16)]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 61, 10)
        assert g.is_contiguous()  # the next block takes resid as its input
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * float(w.abs().max()))

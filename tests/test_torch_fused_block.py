"""The port's fused gated block (plain version, and ResidualBlock both
causal and non-causal) against the JAX package on the CPU. There the JAX
``fused_gated_block`` runs its own composite, as tests/test_pallas_block.py
runs it. Tolerance: rtol 1e-5, atol 1e-6 (f32, the same sums in another
order). The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_kernels.py, chip_smoke.py)."""
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
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block,
                                                      fused_gated_block_ref)

TOL = dict(rtol=1e-5, atol=1e-6)


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
    here; the launch itself needs the card)."""
    a = _cpu_args()
    d = 2
    if case == "dtype":
        a[0] = a[0].double()
    elif case == "shape":
        a[2] = a[2][:-1]
    elif case == "contiguous":
        a[5] = a[5].t().contiguous().t()
    elif case == "divisible":
        a = [torch.from_numpy(v) for v in _args(0, C_in=6, C=8)]
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


def test_autograd_function_accepts_grad_tensors(monkeypatch):
    """The CUDA path is an autograd Function (B4 forward, B5 backward); its
    forward checks its tensors, which require grad there. Run on the CPU
    with the launches replaced by the plain versions: the checks accept the
    tensors, and the Function's gradients equal autograd of the plain
    version."""
    seen = []

    def launch_fwd(*a):
        seen.append(fused_block._check_args(*a))
        return fused_block.fused_gated_block_ref(*a)

    monkeypatch.setattr(fused_block, "_launch_fwd", launch_fwd)
    monkeypatch.setattr(fused_block, "fused_gated_block_bwd",
                        fused_block.fused_gated_block_bwd_ref)
    a = _cpu_args()
    cots = [torch.randn(2, 61, 8, generator=torch.Generator().manual_seed(i))
            for i in range(2)]
    grads = []
    for fn in (fused_block._FusedGatedBlock.apply, fused_gated_block_ref):
        leaves = [t.clone().requires_grad_(True) for t in a]
        r, s = fn(*leaves, 3)
        ((r * cots[0]).sum() + (s * cots[1]).sum()).backward()
        grads.append([t.grad for t in leaves])
    assert seen == [(2, 61, 8, 8, 2)]
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, **TOL)

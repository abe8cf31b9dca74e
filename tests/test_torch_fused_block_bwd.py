"""The fused block's backward (B5) and the models' gradients against the JAX
package on the CPU: ``fused_gated_block_bwd_ref`` against the Pallas
backward kernel in interpret mode and against ``jax.vjp`` of the XLA
composite, for K in {2, 3}, with dilations whose halo exceeds the CUDA
kernel's 32-row tile; then ``ResidualBlock`` (causal and non-causal), a
small ``WaveNet`` and ``WaveNetClassifier`` against ``jax.grad``.
Tolerance: rtol 1e-4, atol 1e-5, as tests/test_pallas_block.py:110-114
(f32 sums over frames and channels in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.models import WaveNet as JWaveNet
from wavenet_speech_tpu.models import WaveNetClassifier as JClassifier
from wavenet_speech_tpu.models.blocks import ResidualBlock as JBlock
from wavenet_speech_tpu.ops.pallas.residual_block import _pallas_bwd, _xla_reference
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.models import WaveNet, WaveNetClassifier
from wavenet_speech_tpu_torch.models.blocks import ResidualBlock
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block_bwd,
                                                      fused_gated_block_bwd_ref)

TOL = dict(rtol=1e-4, atol=1e-5)
NAMES = ("dx", "dWg", "dbg", "dWo", "dbo", "dWr", "dbr")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("B,L,C_in,C,K,d", [(2, 100, 8, 8, 2, 1),
                                            (2, 100, 12, 8, 2, 4),
                                            (1, 90, 16, 16, 3, 8),
                                            (2, 100, 8, 8, 2, 40),   # halo 40 > 32 rows
                                            (1, 120, 8, 12, 3, 20)])  # halo 40
def test_bwd_ref_matches_pallas_and_vjp(B, L, C_in, C, K, d):
    rng = np.random.default_rng(B * L + d)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32) * 0.3
    x, gw, gb = mk(B, L, C_in), mk(K, C_in, 2 * C), mk(2 * C)
    ow, ob, rw, rb = mk(C, 2 * C), mk(2 * C), mk(C_in, C), mk(C)
    dr, dsk = mk(B, L, C), mk(B, L, C)
    j = [jnp.asarray(a) for a in (x, gw, gb, ow, ob, rw, rb)]
    _, vjp = jax.vjp(lambda *a: _xla_reference(*a, dilation=d), *j)
    want_vjp = vjp((jnp.asarray(dr), jnp.asarray(dsk)))
    want_pallas = _pallas_bwd(j[0], j[1], j[3], j[5], jnp.asarray(dr), jnp.asarray(dsk),
                              dilation=d, tile_l=64, gate_b=j[2], interpret=True)
    t = lambda a: torch.from_numpy(a)
    got = fused_gated_block_bwd_ref(t(x), t(gw), t(gb), t(ow), t(rw), t(dr), t(dsk), d)
    wrapped = fused_gated_block_bwd(t(x), t(gw), t(gb), t(ow), t(rw), t(dr), t(dsk), d)
    for name, g, w1, w2, g2 in zip(NAMES, got, want_vjp, want_pallas, wrapped):
        assert torch.equal(g, g2)  # on the CPU the wrapper is the plain version
        np.testing.assert_allclose(g.numpy(), np.asarray(w1), err_msg=f"{name} vs vjp", **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w2), err_msg=f"{name} vs pallas",
                                   **TOL)


def _grads_t(module, x, cot_fn):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt)
    out = out if isinstance(out, tuple) else (out,)
    sum(cot_fn(i, o) for i, o in enumerate(out)).backward()
    return xt.grad.numpy(), {k: p.grad.numpy() for k, p in module.named_parameters()}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [1, 4, 40])
def test_residual_block_grads_match_jax(causal, d):
    jblk = JBlock(12, 8, 2, d, causal=causal)
    params = jblk.init(jax.random.PRNGKey(d))
    tblk = ResidualBlock(12, 8, 2, d, causal=causal, device="cpu")
    tblk.load_state_dict(bridge._block(_np_tree(params), ""))
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 90, 12)).astype(np.float32)
    cots = [rng.standard_normal((2, 90, 8)).astype(np.float32) for _ in range(2)]

    def jloss(p, xx):
        r, s = jblk.apply(p, xx)
        return jnp.sum(r * cots[0]) + jnp.sum(s * cots[1])
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    tgx, tgp = _grads_t(tblk, x, lambda i, o: (o * torch.from_numpy(cots[i])).sum())
    np.testing.assert_allclose(tgx, np.asarray(gx), **TOL)
    want = bridge._block(_np_tree(gp), "")
    for k, v in tgp.items():
        np.testing.assert_allclose(v, want[k].numpy(), err_msg=k, **TOL)


def test_wavenet_and_classifier_grads_match_jax():
    C = 16
    layers = tuple((C, C, 2, d) for d in (1, 2, 4, 8))
    jnet = JWaveNet(C, 2, layers, C, softmax=False)
    jclf = JClassifier(C, 5, tuple((C, C, 2, d) for d in (1, 2)), C,
                       pool_kernel_size=4, softmax=False)
    pn, pc = jnet.init(jax.random.PRNGKey(0)), jclf.init(jax.random.PRNGKey(1))
    tnet = WaveNet(C, 2, layers, C, softmax=False, device="cpu")
    tclf = WaveNetClassifier(C, 5, tuple((C, C, 2, d) for d in (1, 2)), C,
                             pool_kernel_size=4, softmax=False, device="cpu")
    tnet.load_state_dict(bridge.wavenet_from_jax(_np_tree(pn)))
    tclf.load_state_dict(bridge.classifier_from_jax(_np_tree(pc)))
    rng = np.random.default_rng(3)
    x = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(2, 96))]
    cot_n = rng.standard_normal((2, 96, C)).astype(np.float32)
    cot_c = rng.standard_normal((2, 24, 5)).astype(np.float32)

    def jloss(pn_, pc_, xx):
        h = jnet.apply(pn_, xx)
        return jnp.sum(h * cot_n) + jnp.sum(jclf.apply(pc_, h) * cot_c)
    gn, gc, gx = jax.grad(jloss, argnums=(0, 1, 2))(pn, pc, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    h = tnet(xt)
    ((h * torch.from_numpy(cot_n)).sum()
     + (tclf(h) * torch.from_numpy(cot_c)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    for module, want in ((tnet, bridge.wavenet_from_jax(_np_tree(gn))),
                         (tclf, bridge.classifier_from_jax(_np_tree(gc)))):
        for k, p in module.named_parameters():
            # the last block's res_w, res_b reach no output: no grad in torch,
            # zeros in JAX
            got = torch.zeros_like(p) if p.grad is None else p.grad
            np.testing.assert_allclose(got.numpy(), want[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("case", ["accept", "shape", "contiguous", "taps"])
def test_bwd_kernel_argument_checks(case):
    """The checks the backward wrapper makes before a launch (on CPU
    tensors here; the launch needs the card)."""
    from wavenet_speech_tpu_torch.ops import fused_block
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    K = 9 if case == "taps" else 2
    x, gw, gb, ow, rw = mk(2, 30, 8), mk(K, 8, 16), mk(16), mk(8, 16), mk(8, 8)
    dr, ds = mk(2, 30, 8), mk(2, 30, 8)
    if case == "shape":
        ds = ds[:, :-1].contiguous()
    elif case == "contiguous":
        dr = dr.transpose(0, 1).contiguous().transpose(0, 1)
    check = lambda: fused_block._check_args(x, gw, gb, ow, None, rw, None, 3,
                                            dresid=dr, dskip=ds)
    if case == "accept":
        assert check() == (2, 30, 8, 8, 2)
    else:
        with pytest.raises(ValueError):
            check()

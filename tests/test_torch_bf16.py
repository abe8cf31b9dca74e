"""bf16 in the port against the JAX package on the CPU: the plain bf16
versions of the fused block kernels (B4-bf16, B5-bf16), the argument checks
that route a bf16 call, and the bf16 joint train and eval steps.

Tolerances:
- B5-bf16's plain version against JAX ``_pallas_bwd(..., interpret=True)``
  on bf16 inputs (the TPU kernel's own arithmetic): each output within
  2^-7 x max|JAX|, two bf16 steps at the max (observed: equal, but for one
  element of dWg 2.5e-5 x max).
- B4-bf16's plain version against JAX ``_xla_reference`` in bf16 (the JAX
  forward kernel has no interpret switch; its composite also rounds the
  gate and the products to bf16): within 2^-6 x max (observed <= 7.9e-3).
- The bf16 steps calibrate themselves on JAX's own bf16 rounding: jd =
  ||jax_bf16 - jax_f32|| for each metric (over the 3 steps) and for the
  params after 3 steps (relative norm), and the port's float32 step equals
  JAX's. The port's bf16 step must be off float32 by the size of a bf16
  run's rounding: BF16_LOW x jd <= ||port_bf16 - jax_f32|| <= jd, so a port
  that ran in float32 (0) or rounded more than JAX does fails (observed
  0.46-0.82). For the losses and the params the port also stays within jd
  of JAX's bf16 run (observed 0.45-0.95). grad_norm is held through float32
  only: the two bf16 runs round in other places (JAX's CPU step runs the
  XLA composite, which rounds the gate to bf16 before tanh and sigmoid; the
  port keeps the TPU kernel's float32 gate), so they leave float32 in other
  directions, and on grad_norm in opposite ones: port to JAX bf16 1.41 jd
  (full) and 1.69 jd (length-aware), within the 2 jd that the triangle
  inequality allows once the port is within jd of float32 (0.65, 0.76).
  Every causal block of the port's bf16 steps sees bf16 activations.
- The bf16 eval step: |port_bf16 - jax_bf16| <= jd and |port_bf16 - jax_f32|
  >= BF16_LOW x jd for each loss (observed 0.07-0.38 and 0.62-1.07)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training import POOL, _batch, _models
from wavenet_speech_tpu.ops.pallas.residual_block import _pallas_bwd, _xla_reference
from wavenet_speech_tpu.training import JointLoss as JJointLoss
from wavenet_speech_tpu.training import TrainState as JTrainState
from wavenet_speech_tpu.training import build_optimizer as j_build_optimizer
from wavenet_speech_tpu.training import make_eval_step as j_make_eval_step
from wavenet_speech_tpu.training import make_joint_train_step as j_make_joint_train_step
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.models import blocks
from wavenet_speech_tpu_torch.ops import fused_block
from wavenet_speech_tpu_torch.ops.fused_block import (fused_gated_block,
                                                      fused_gated_block_bwd,
                                                      fused_gated_block_bwd_ref,
                                                      fused_gated_block_ref)
from wavenet_speech_tpu_torch.training import (JointLoss, build_optimizer, make_eval_step,
                                               make_joint_train_step)
from wavenet_speech_tpu_torch.utils.tree import tree_leaves

BF16_LOW = 0.25
B5_OUTPUTS = ("dx", "dWg", "dbg", "dWo", "dbo", "dWr", "dbr")


def _block_args(seed, B=2, L=64, C_in=16, C=16, K=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.uniform(-1, 1, s).astype(np.float32)
    return ([f(B, L, C_in), f(K, C_in, 2 * C) * 0.4, f(2 * C) * 0.1, f(C, 2 * C) * 0.4,
             f(2 * C) * 0.1, f(C_in, C) * 0.4, f(C) * 0.1], f(B, L, C), f(B, L, C))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _jbf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _f32(t):
    return np.asarray(t.float() if torch.is_tensor(t) else t.astype(jnp.float32))


@pytest.mark.parametrize("shape,d", [((2, 64, 16, 16, 2), 1), ((2, 64, 16, 16, 2), 8),
                                     ((1, 40, 8, 12, 3), 5)])
def test_b5_bf16_plain_matches_jax_kernel_interpret(shape, d):
    a, dr, ds = _block_args(d, *shape)
    x, gw, gb, ow, _, rw, _ = a
    want = _pallas_bwd(_jbf16(x), _jbf16(gw), _jbf16(ow), _jbf16(rw), _jbf16(dr), _jbf16(ds),
                       dilation=d, tile_l=32, gate_b=_jbf16(gb), interpret=True)
    got = fused_gated_block_bwd_ref(*map(_bf16, (x, gw, gb, ow, rw, dr, ds)), d)
    for name, g, w in zip(B5_OUTPUTS, got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        assert tuple(g.shape) == w.shape, name
        scale = np.abs(_f32(w)).max()
        np.testing.assert_array_less(np.abs(_f32(g) - _f32(w)), 2.0 ** -7 * scale + 1e-30,
                                     err_msg=name)


@pytest.mark.parametrize("shape,d", [((2, 64, 16, 16, 2), 1), ((2, 64, 16, 16, 2), 8),
                                     ((1, 40, 8, 12, 3), 5)])
def test_b4_bf16_plain_matches_jax_composite(shape, d):
    a, _, _ = _block_args(d + 100, *shape)
    want = _xla_reference(*map(_jbf16, a), dilation=d)
    got = fused_gated_block_ref(*map(_bf16, a), d)
    for name, g, w in zip(("resid", "skip"), got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        scale = np.abs(_f32(w)).max()
        np.testing.assert_array_less(np.abs(_f32(g) - _f32(w)), 2.0 ** -6 * scale, err_msg=name)


def test_bf16_plain_forward_rounds_like_the_kernel():
    """The plain bf16 forward is the float32 math on the widened inputs,
    with act rounded to bf16 before the 1x1 product and the outputs rounded:
    equal to that computed by hand, and bf16 on a CPU tensor through the
    wrapper, which launches nothing."""
    a, _, _ = _block_args(7)
    t = [_bf16(v) for v in a]
    x, gw, gb, ow, ob, rw, rb = (v.float() for v in t)
    g = gb + x @ gw[1] + torch.nn.functional.pad(x, (0, 0, 3, 0))[:, :64] @ gw[0]
    act = (torch.tanh(g[..., :16]) * torch.sigmoid(g[..., 16:])).to(torch.bfloat16).float()
    o = act @ ow + ob
    before = (fused_gated_block.launches, fused_gated_block.launches_bf16)
    r, s = fused_gated_block(*t, 3)
    assert (fused_gated_block.launches, fused_gated_block.launches_bf16) == before
    assert r.dtype == s.dtype == torch.bfloat16
    torch.testing.assert_close(r, (o[..., :16] + x @ rw + rb).to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(s, o[..., 16:].to(torch.bfloat16), rtol=0, atol=0)
    grads = fused_gated_block_bwd(t[0], t[1], t[2], t[3], t[5], t[0][..., :16], t[0][..., :16], 3)
    assert all(g.dtype == torch.bfloat16 for g in grads)


@pytest.mark.parametrize("case", ["all_bf16", "mixed", "float16", "unaligned"])
def test_kernel_argument_checks_bf16(case):
    """A call takes one type for every tensor, float32 or bf16, each aligned
    to four values (8 bytes in bf16)."""
    a, dr, _ = _block_args(0, C_in=8, C=8)
    t = [_bf16(v) for v in a]
    if case == "all_bf16":
        assert fused_block._check_args(*t, 2) == (2, 64, 8, 8, 2)
        assert fused_block._check_args(t[0], t[1], t[2], t[3], None, t[5], None, 2,
                                       dresid=_bf16(dr), dskip=_bf16(dr)) == (2, 64, 8, 8, 2)
        return
    if case == "mixed":
        t[3] = t[3].float()
    elif case == "float16":
        t = [v.half() for v in t]
    else:
        t[0] = torch.zeros(2 * 64 * 8 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 8)
    with pytest.raises(ValueError):
        fused_block._check_args(*t, 2)


# ---- the bf16 steps ---------------------------------------------------------------

def _dist(a, b):
    return float(np.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))))


def _run_jax(jnet, jclf, params, dtype, kw):
    tx = j_build_optimizer("adagrad", 1e-2)
    step = j_make_joint_train_step(jnet, jclf, tx, JJointLoss("joint"), donate=False,
                                   compute_dtype=dtype, **kw)
    state = JTrainState.create(params, tx)
    hist = []
    for _ in range(3):
        state, m = step(state, {k: jnp.asarray(v) for k, v in _batch().items()})
        hist.append({k: float(v) for k, v in m.items()})
    return hist, [t.numpy() for t in tree_leaves(bridge.param_tree_from_jax(state.params))]


@pytest.mark.parametrize("mode", ["full", "length_aware"])
def test_bf16_joint_steps_match_jax(mode, monkeypatch):
    jnet, jclf, tnet, tclf, params = _models()
    kw = {"logit_length_fn": lambda l: l // POOL} if mode == "length_aware" else {}
    j32, p32 = _run_jax(jnet, jclf, params, None, kw)
    j16, p16 = _run_jax(jnet, jclf, params, jnp.bfloat16, kw)
    seen = []

    def recording_block(x, *w_and_d, **kind):
        seen.append({x.dtype} | {t.dtype for t in w_and_d[:-1]})
        return fused_gated_block(x, *w_and_d, **kind)

    monkeypatch.setattr(blocks, "fused_gated_block", recording_block)
    tx = build_optimizer("adagrad", 1e-2)
    step = make_joint_train_step(tnet, tclf, tx, JointLoss("joint"),
                                 compute_dtype=torch.bfloat16, **kw)
    state = bridge.train_state_from_jax(JTrainState.create(
        params, j_build_optimizer("adagrad", 1e-2)))
    t16 = []
    for _ in range(3):
        state, m = step(state, _batch())
        t16.append({k: float(v) for k, v in m.items()})
    n_blocks = sum(isinstance(m, blocks.ResidualBlock) for net in (tnet, tclf)
                   for m in net.modules())   # causal and centred: all on the fused block
    assert seen == [{torch.bfloat16}] * (3 * n_blocks)
    assert all(t.dtype == torch.float32 for t in tree_leaves(state.params))
    assert all(m["skipped_nonfinite"] == 0 for m in t16)
    for k in j16[0]:
        series = lambda h: [np.array([m[k] for m in h])]
        jax_d = _dist(series(j16), series(j32))
        if k == "skipped_nonfinite":
            continue
        to_f32 = _dist(series(t16), series(j32))
        print(f"{mode} {k}: port to jax_f32 {to_f32 / jax_d:.2f} jd, port to jax_bf16 "
              f"{_dist(series(t16), series(j16)) / jax_d:.2f} jd")   # read with -s
        assert BF16_LOW * jax_d <= to_f32 <= jax_d, (k, to_f32, jax_d)
        if k != "grad_norm":
            assert _dist(series(t16), series(j16)) <= jax_d, (k, jax_d)
    pt = [t.numpy() for t in tree_leaves(state.params)]
    rel = lambda a, b: _dist(a, b) / _dist(b, [0 * p for p in b])
    jax_d = rel(p16, p32)
    print(f"{mode} params: port to jax_f32 {rel(pt, p32) / jax_d:.2f} jd, port to jax_bf16 "
          f"{rel(pt, p16) / jax_d:.2f} jd")
    assert BF16_LOW * jax_d <= rel(pt, p32) <= jax_d, ("params", rel(pt, p32), jax_d)
    assert rel(pt, p16) <= jax_d, ("params", rel(pt, p16), jax_d)


def test_bf16_eval_step_matches_jax():
    jnet, jclf, tnet, tclf, params = _models()
    fn = lambda l: l // POOL
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    j32 = j_make_eval_step(jnet, jclf, logit_length_fn=fn)(params, batch)
    j16 = j_make_eval_step(jnet, jclf, compute_dtype=jnp.bfloat16,
                           logit_length_fn=fn)(params, batch)
    t16 = make_eval_step(tnet, tclf, compute_dtype=torch.bfloat16, logit_length_fn=fn)(
        bridge.param_tree_from_jax(params), _batch())
    assert sorted(t16) == sorted(j16)
    for k in j16:
        assert t16[k].dtype == torch.float32
        jax_d = abs(float(j16[k]) - float(j32[k]))
        print(f"eval {k}: port to jax_bf16 {abs(float(t16[k]) - float(j16[k])) / jax_d:.2f} jd, "
              f"port to jax_f32 {abs(float(t16[k]) - float(j32[k])) / jax_d:.2f} jd")
        assert abs(float(t16[k]) - float(j16[k])) <= jax_d, k
        assert abs(float(t16[k]) - float(j32[k])) >= BF16_LOW * jax_d, k

"""The port's normalizations against the JAX package on the CPU:
ops/norm.py's batch_standardize and LayerNorm (Bessel's std, eps added to
the std), and facade.BatchNorm1d's training form, update_state (the
running-statistics EMA, over 5 batches) and eval form, held against JAX's
BatchNorm1d and against torch.nn.BatchNorm1d as JAX's
test_batchnorm_running_stats_match_torch does. Tolerance: rtol 1e-5,
atol 1e-6 (float32 means and variances over a few hundred values in
another order); against torch.nn, JAX's own test's rtol 1e-4, atol 1e-5
for the outputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu import facade as jfacade
from wavenet_speech_tpu.ops.norm import LayerNorm as JLayerNorm
from wavenet_speech_tpu.ops.norm import batch_standardize as j_batch_standardize
from wavenet_speech_tpu_torch.facade import BatchNorm1d, Model
from wavenet_speech_tpu_torch.ops.norm import LayerNorm, batch_standardize

TOL = dict(rtol=1e-5, atol=1e-6)


def _x(shape, seed, scale=3.0, shift=1.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(4, 33, 1), (2, 17, 3), (5, 8)])
def test_batch_standardize_matches_jax(shape):
    x = _x(shape, 1)
    x[0, -3:] = 0.0  # padding frames count in the statistics
    got = batch_standardize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_batch_standardize(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    axes = tuple(range(x.ndim - 1))
    np.testing.assert_allclose(got.mean(axis=axes), 0.0, atol=1e-5)
    np.testing.assert_allclose(got.var(axis=axes), 1.0, rtol=1e-3)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layernorm_matches_jax(axis):
    x = _x((2, 6, 6), 2)
    jln = JLayerNorm(6, axis=axis)
    p = {"gamma": np.linspace(0.5, 2.0, 6).astype(np.float32),
         "beta": np.linspace(-1.0, 1.0, 6).astype(np.float32)}
    ln = LayerNorm(6, axis=axis, device="cpu")
    ln.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    with torch.no_grad():
        got = ln(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jln.apply(p, jnp.asarray(x))), **TOL)
    # Bessel's std with eps on the std: not torch's nn.LayerNorm
    xs = torch.from_numpy(x).movedim(axis, -1)
    std = xs.std(dim=-1, keepdim=True)
    want = (xs - xs.mean(dim=-1, keepdim=True)) / (std + 1e-6) * torch.from_numpy(p["gamma"]) \
        + torch.from_numpy(p["beta"])
    np.testing.assert_allclose(got, want.movedim(-1, axis).numpy(), **TOL)
    ln.reset_parameters()
    assert torch.equal(ln.gamma, torch.ones(6)) and torch.equal(ln.beta, torch.zeros(6))


def test_batchnorm_train_update_eval_match_jax_and_torch():
    """5 training batches: the train forward (batch statistics), then
    update_state; the running mean and var, and the eval form on a new
    batch, equal JAX's and torch.nn.BatchNorm1d(1)'s."""
    jbn = jfacade.BatchNorm1d(1)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in
          (("gamma", [1.3]), ("beta", [-0.2]), ("mean", [0.0]), ("var", [1.0]))}
    bn = BatchNorm1d(1, device="cpu")
    bn.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in jp.items()})
    tbn = torch.nn.BatchNorm1d(1)
    with torch.no_grad():
        tbn.weight.fill_(1.3)
        tbn.bias.fill_(-0.2)
    tbn.train()
    params = {k: v.detach().clone() for k, v in bn.state_dict().items()}
    for i in range(5):
        x = _x((4, 33, 1), 7 + i)
        with torch.no_grad():
            y = torch.func.functional_call(bn, params, (torch.from_numpy(x),)).numpy()
        np.testing.assert_allclose(y, np.asarray(jbn.apply(jp, jnp.asarray(x))), **TOL)
        ty = tbn(torch.from_numpy(x).permute(0, 2, 1)).detach().numpy()
        np.testing.assert_allclose(y[..., 0], ty[:, 0, :], rtol=1e-4, atol=1e-5)
        # the optimizer's new leaves pass through; mean and var come from
        # the old ones
        moved = {k: v + 1.0 for k, v in params.items()}
        new = bn.update_state(params, moved, torch.from_numpy(x))
        assert torch.equal(new["gamma"], moved["gamma"]) and torch.equal(new["beta"],
                                                                         moved["beta"])
        params = dict(params, mean=new["mean"], var=new["var"])
        jp = jbn.update_state(jp, jp, jnp.asarray(x))
    for k in ("mean", "var"):
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), **TOL)
    np.testing.assert_allclose(params["mean"].numpy(), tbn.running_mean.numpy(), **TOL)
    np.testing.assert_allclose(params["var"].numpy(), tbn.running_var.numpy(), **TOL)

    tbn.eval()
    bn.load_state_dict(params)
    ev = bn.eval_form()
    assert ev.use_running and not bn.use_running and ev.gamma is bn.gamma
    xe = _x((1, 9, 1), 99)
    with torch.no_grad():
        ye = ev(torch.from_numpy(xe)).numpy()
    jy = dataclasses.replace(jbn, use_running=True).apply(jp, jnp.asarray(xe))
    np.testing.assert_allclose(ye, np.asarray(jy), **TOL)
    np.testing.assert_allclose(ye[..., 0], tbn(torch.from_numpy(xe).permute(0, 2, 1))
                               .detach().numpy()[:, 0, :], rtol=1e-4, atol=1e-5)


def test_model_eval_base_shares_the_parameters():
    cfg = {"model": {"type": "raw-ctcnet", "raw": {"num_features": 4, "out_dim": 4,
                                                    "num_dilation_blocks": 1,
                                                    "dilations": [1]}}}
    m = Model("raw-ctcnet", cfg, device="cpu").init(0)
    ev = m.eval_base()
    assert ev.use_running and not m.model_base.use_running
    assert sorted(m.state_dict()) == sorted(Model("raw-ctcnet", cfg, device="cpu").state_dict())
    with torch.no_grad():
        m.model_base.mean.fill_(2.0)
        m.model_base.var.fill_(4.0)
        x = torch.full((1, 5, 1), 4.0)
        assert torch.allclose(m.eval_base()(x), torch.full_like(x, 1.0), atol=1e-5)
        assert torch.allclose(m.predict(x)[0], torch.full_like(x, 1.0), atol=1e-5)
        assert torch.equal(m.model_base(x), torch.zeros_like(x))  # the train form

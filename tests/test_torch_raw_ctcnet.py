"""The port's RawCTCNet, eval-mode BatchNorm1d and Model("raw-ctcnet")
against the JAX package on the CPU, JAX params carried over by the bridge
(unrolled and cycle-stacked stacks), on raw float signals made from a seed.
Tolerance: rtol 1e-4, atol 1e-5, as the other model tests (sums over
several blocks in another order). Also the new init arguments, hardtanh,
with_noise, and that a raw-ctcnet pair trains: BatchNorm1d's training form
and update_state, the train and eval steps, and the CLI's train command
(held to JAX in tests/test_torch_norm.py, test_torch_ctc_step.py and
test_torch_evaluate.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu import facade as jfacade
from wavenet_speech_tpu.models import RawCTCNet as JRawCTCNet
from wavenet_speech_tpu.nn import initializers as jinit
from wavenet_speech_tpu.ops.activations import hardtanh as jhardtanh
from wavenet_speech_tpu_torch import bridge, cli
from wavenet_speech_tpu_torch.facade import BatchNorm1d, Model
from wavenet_speech_tpu_torch.models import RawCTCNet, ResidualBlock, SkipSumStack
from wavenet_speech_tpu_torch.nn import initializers as init
from wavenet_speech_tpu_torch.ops.activations import hardtanh
from wavenet_speech_tpu_torch.training import (build_optimizer, make_eval_step,
                                               make_joint_train_step)

TOL = dict(rtol=1e-4, atol=1e-5)
F = 12


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _raw(B, L, seed):
    return np.random.default_rng(seed).standard_normal((B, L, 1)).astype(np.float32)


def raw_cfg(blocks=2, dilations=(1, 2), F=F, causal=False):
    return {"model": {"type": "raw-ctcnet",
                      "raw": {"num_features": F, "feature_kwidth": 3, "num_labels": 5,
                              "num_dilation_blocks": blocks, "kernel": 3,
                              "dilations": list(dilations), "out_dim": F,
                              "causal": causal}}}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("positions", [False, True])
def test_raw_ctcnet_matches_jax(positions, causal):
    """Output L + fk - 1 frames; causal blocks run the fused block's plain
    version on the CPU, non-causal ones the composite."""
    layers = tuple((F, F, 3, d) for d in (1, 2, 4)) * 2
    jnet = JRawCTCNet(F, 3, 5, layers, F, positions=positions, softmax=False, causal=causal)
    params = jnet.init(jax.random.PRNGKey(0))
    tnet = RawCTCNet(F, 3, 5, layers, F, positions=positions, softmax=False, causal=causal,
                     device="cpu")
    tnet.load_state_dict(bridge.raw_ctcnet_from_jax(_np_tree(params)))
    x = _raw(2, 150, 1)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x))
    ref = np.asarray(jnet.apply(params, jnp.asarray(x)))
    assert out.shape == ref.shape == (2, 150 + 2, 5)
    assert tnet.output_length(150) == jnet.output_length(150) == 152
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_raw_ctcnet_softmax_matches_jax():
    layers = ((F, F, 3, 1), (F, F, 3, 2))
    jnet = JRawCTCNet(F, 5, 5, layers, F)
    params = jnet.init(jax.random.PRNGKey(3))
    tnet = RawCTCNet(F, 5, 5, layers, F, device="cpu")
    tnet.load_state_dict(bridge.raw_ctcnet_from_jax(_np_tree(params)))
    x = _raw(1, 64, 3)
    with torch.no_grad():
        out = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jnet.apply(params, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)


def test_batchnorm_eval_matches_jax():
    """The running-statistics form with gamma, beta, mean and var away from
    their init."""
    rng = np.random.default_rng(4)
    p = {k: rng.uniform(0.5, 2.0, size=(1,)).astype(np.float32)
         for k in ("gamma", "beta", "mean", "var")}
    jbn = jfacade.BatchNorm1d(1, use_running=True)
    bn = BatchNorm1d(1, device="cpu")
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in p.items()})
    x = _raw(2, 40, 5) * 3
    with torch.no_grad():
        got = bn.eval_form()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbn.apply(p, jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)


def test_batchnorm_training_form_raises():
    """BatchNorm1d trains: its forward normalizes with the batch's
    statistics, its eval form with the running ones, update_state keeps
    the running EMA, and the train step takes the module."""
    bn = BatchNorm1d(1, device="cpu")
    bn.reset_parameters()
    assert [float(getattr(bn, k).detach()) for k in ("gamma", "beta", "mean", "var")] == [1, 0, 0, 1]
    x = torch.arange(8.0).reshape(2, 4, 1)
    with torch.no_grad():
        assert torch.allclose(bn(x), (x - 3.5) / (5.25 + 1e-5) ** 0.5)
        assert torch.equal(bn.eval_form()(torch.ones(1, 4, 1)),
                           torch.ones(1, 4, 1) * (1 / (1 + 1e-5) ** 0.5))
    params = {k: v.detach() for k, v in bn.state_dict().items()}
    new = bn.update_state(params, params, x)
    assert torch.allclose(new["mean"], torch.tensor([0.35]))
    assert torch.allclose(new["var"], torch.tensor([0.9 + 0.1 * 6.0]))
    make_joint_train_step(bn, torch.nn.Identity(), build_optimizer("adam", 1e-3))


@pytest.mark.parametrize("blocks", [1, 2])  # unrolled, cycle-stacked
def test_model_raw_ctcnet_predict_matches_jax(blocks):
    cfg = raw_cfg(blocks)
    jm = jfacade.Model("raw-ctcnet", cfg)
    params = jm.init(jax.random.PRNGKey(2))
    assert ("cycle" in params["ctc"]["stack"]) == (blocks > 1)
    params["base"] = {k: jnp.asarray([v], jnp.float32)
                      for k, v in (("gamma", 1.5), ("beta", 0.2), ("mean", -0.3), ("var", 2.0))}
    tm = Model("raw-ctcnet", cfg, device="cpu").load_jax(_np_tree(params))
    x = _raw(2, 130, 6)
    with torch.no_grad():
        base, logits = tm.predict(torch.from_numpy(x))
        assert torch.equal(tm(torch.from_numpy(x)), logits)
    jbase, jlogits = jm.predict(params, jnp.asarray(x))
    np.testing.assert_allclose(base.numpy(), np.asarray(jbase), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert logits.shape == (2, 132, 5)
    assert tm.output_length(130) == 132 and tm.feature_kwidth == 3
    assert tm.layers == jm.model_ctc.layers
    assert not hasattr(tm, "entry_kwidth")


def test_model_raw_ctcnet_init_is_seeded_and_noisy():
    a = Model("raw-ctcnet", raw_cfg(), device="cpu").init(3)
    b = Model("raw-ctcnet", raw_cfg(), device="cpu").init(3)
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    names = set(a.state_dict())
    want = set(bridge.params_from_jax(_np_tree(
        jfacade.Model("raw-ctcnet", raw_cfg()).init(jax.random.PRNGKey(0)))))
    assert names == want
    r = a.model_ctc
    for w in (r.input_bottleneck.w, r.stack.bottlenecks[0].w):  # eye + 1e-4 noise
        d = (w - torch.eye(F)).detach()
        assert 0 < float(d.abs().max()) < 1e-3
    for bias in (r.feat_conv.b, r.out2.b, r.stack.blocks[0].gate_b):  # zeros + 1e-4 noise
        assert 0 < float(bias.detach().abs().max()) < 1e-3
    assert float(r.feat_conv.w.detach().abs().max()) <= (6 / 3) ** 0.5
    assert [float(getattr(a.model_base, k).detach()) for k in ("gamma", "beta", "mean", "var")] == \
        [1, 0, 0, 1]


def test_model_raw_ctcnet_save_restore(tmp_path):
    a = Model("raw-ctcnet", raw_cfg(), device="cpu").init(5)
    with torch.no_grad():
        a.model_base.mean.fill_(0.25)
    a.save(str(tmp_path / "p.pt"))
    b = Model("raw-ctcnet", raw_cfg(), device="cpu").init(6)
    b.restore(str(tmp_path / "p.pt"))
    for (na, pa), (nb, pb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)


def test_training_raw_ctcnet_raises(tmp_path):
    """Training a raw-ctcnet pair runs: the steps build, and the CLI trains
    (CTC loss by default) and moves BatchNorm's running statistics."""
    m = Model("raw-ctcnet", raw_cfg(), device="cpu").init(0)
    tx = build_optimizer("adamax", 2e-4)
    make_joint_train_step(m.model_base, m.model_ctc, tx)
    make_eval_step(m.eval_base(), m.model_ctc)
    cfg = raw_cfg()
    cfg["training"] = {"datatype": "raw-gauss", "save_dir": str(tmp_path), "batch_size": 2,
                       "min_sample_length": 20, "max_sample_length": 24, "upsampling": 3,
                       "max_iters": 2, "print_every": 1, "save_every": 2}
    ds, model, state, *_, t = cli.build_from_config(cfg, "cpu")
    assert ds.signal_channels == 1 and model.model_type == "raw-ctcnet"
    assert cli.train_with_result(cfg, "cpu")["steps"] == 2
    base = torch.load(tmp_path / "ckpts" / "2" / "state.pt", weights_only=False)["params"]["base"]
    assert float(base["mean"]) > 1 and float(base["var"]) > 1


def test_init_arguments_default_to_the_old_behaviour():
    g = torch.Generator().manual_seed(0)
    blk = ResidualBlock(4, 4, 2, 1, device="cpu")
    blk.reset_parameters(g)
    assert not blk.gate_b.any() and not blk.res_b.any()
    st = SkipSumStack(((4, 4, 2, 1),), 4, device="cpu")
    st.reset_parameters(g)
    assert torch.equal(st.bottlenecks[0].w, torch.eye(4)) and not st.bottlenecks[0].b.any()
    ones = lambda shape, generator=None: torch.ones(shape)
    st = SkipSumStack(((4, 4, 2, 1),), 4, b_init=ones, bottleneck_w_init=init.zeros,
                      bottleneck_b_init=ones, device="cpu")
    st.reset_parameters(g)
    assert bool((st.blocks[0].gate_b == 1).all()) and not st.bottlenecks[0].w.any()
    assert bool((st.bottlenecks[0].b == 1).all())


def test_hardtanh_and_with_noise():
    x = np.linspace(-3, 3, 61, dtype=np.float32)
    np.testing.assert_array_equal(hardtanh(torch.from_numpy(x)).numpy(),
                                  np.asarray(jhardtanh(jnp.asarray(x))))
    np.testing.assert_array_equal(hardtanh(torch.from_numpy(x), -0.5, 2.0).numpy(),
                                  np.asarray(jhardtanh(jnp.asarray(x), -0.5, 2.0)))
    # the same distribution as JAX's: base + eps N(0, 1)
    shape = (256, 256)
    got = init.with_noise(init.eye, 1e-4)(shape, torch.Generator().manual_seed(0)) - \
        torch.eye(*shape)
    ref = np.asarray(jinit.with_noise(jinit.eye, 1e-4)(jax.random.PRNGKey(0), shape)) - \
        np.eye(*shape)
    for a in (got.numpy(), ref):
        assert abs(a.mean()) < 2e-6 and abs(a.std() / 1e-4 - 1) < 0.02


# ---- RawCTCNet under SP and the raw-ctcnet pair on DP/SP meshes (gloo ranks) ------

from wavenet_speech_tpu.ops.ctc import ctc_loss_per_seq as j_ctc_loss_per_seq  # noqa: E402
from wavenet_speech_tpu.training import JointLoss as JJointLoss  # noqa: E402
from wavenet_speech_tpu_torch.parallel import run_ranks, seq_axis  # noqa: E402
from wavenet_speech_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from wavenet_speech_tpu_torch.training import JointLoss  # noqa: E402

import torch_rank_programs  # noqa: E402

SP_B, SP_L, SP_LABELS = 4, 64, 6
SP_CASES = [(3, 2), (5, 2), (5, 4)]      # (feature_kwidth, seq shards)
POS_CASES = {2: 3, 4: 5}                  # seq shards -> feature_kwidth, positions in f64
PAIR_MESHES = {"data": (2, 1), "seq": (1, 2)}


def _sp_nets(fk, positions=False):
    """JAX's RawCTCNet and its float32 params (numpy), the port's and its
    params."""
    layers = tuple((F, F, 3, d) for d in (1, 2))
    jnet = JRawCTCNet(F, fk, 5, layers, F, positions=positions, softmax=False)
    params = _np_tree(jnet.init(jax.random.PRNGKey(fk)))
    tnet = RawCTCNet(F, fk, 5, layers, F, positions=positions, softmax=False, device="cpu")
    return jnet, params, tnet, bridge.raw_ctcnet_from_jax(params)


def _sp_labels():
    rng = np.random.default_rng(11)
    return (rng.integers(1, 5, size=(SP_B, SP_LABELS)).astype(np.int32),
            np.array([6, 5, 3, 6], np.int32))


def _pos_weight(fk):
    return np.random.default_rng(fk + 1).standard_normal((SP_B, SP_L + fk - 1, 5))


def _pair_batch():
    rng = np.random.default_rng(21)
    labels, ll = _sp_labels()
    return {"signal": (80 + 8 * rng.standard_normal((SP_B, SP_L, 1))).astype(np.float32),
            "labels": labels, "label_lengths": ll}


@pytest.fixture(scope="module")
def sp_runs():
    """One world of 2 ranks and one of 4: RawCTCNet under SP (the CTC loss
    and gradients; with positions, the float64 logits and the gradient of
    a weighted sum of them), and the raw-ctcnet pair's objective and one
    Adamax step on (data 2) and (seq 2)."""
    x = _raw(SP_B, SP_L, 9)
    labels, ll = _sp_labels()
    rp = torch_rank_programs
    runs = {}
    for n in (2, 4):
        calls = [(rp.raw_ctcnet_sp, ((1, n), _sp_nets(fk)[2], _sp_nets(fk)[3], x, labels, ll))
                 for fk, m in SP_CASES if m == n]
        fk = POS_CASES[n]
        _, _, tnet, tparams = _sp_nets(fk, True)
        calls.append((rp.raw_ctcnet_sp, ((1, n), tnet.double(),
                                         {k: v.double() for k, v in tparams.items()},
                                         x.astype(np.float64), None, None, _pos_weight(fk))))
        if n == 2:
            m = Model("raw-ctcnet", raw_cfg(), device="cpu")
            params = bridge.param_tree_from_jax(_np_tree(_pair_jax()[1]))
            for shape in PAIR_MESHES.values():
                calls.append((rp.joint_value_and_grad, (shape, m.model_base, m.model_ctc,
                                                        params, _pair_batch(), None,
                                                        JointLoss("ctc"))))
                calls.append((rp.joint_train_steps, (shape, m.model_base, m.model_ctc, params,
                                                     _pair_batch(), "adamax", 2e-4, 1, None,
                                                     JointLoss("ctc"))))
        runs[n] = run_ranks(rp.several, n, "gloo", calls, timeout=180.0)
    return runs


@pytest.mark.parametrize("fk,n", SP_CASES)
def test_raw_ctcnet_sp_loss_and_grads_match_jax(sp_runs, fk, n):
    """CTC (a batch sum over T = L + fk - 1) of RawCTCNet on n seq shards
    against JAX's single device: the loss rtol 1e-5, every gradient leaf
    rtol 1e-4, atol 1e-5 (__graft_entry__.py's tolerances)."""
    jnet, params, _, _ = _sp_nets(fk)
    labels, ll = _sp_labels()
    x = jnp.asarray(_raw(SP_B, SP_L, 9))

    def loss(p):
        logits = jnet.apply(p, x)
        T = logits.shape[1]
        return jnp.sum(j_ctc_loss_per_seq(logits, jnp.full((SP_B,), T, jnp.int32),
                                          jnp.asarray(labels), jnp.asarray(ll))) / T

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    want = bridge.raw_ctcnet_from_jax(_np_tree(grads))
    k = [c for c in SP_CASES if c[1] == n].index((fk, n))
    for r, out in enumerate(sp_runs[n]):
        got = out[k]
        np.testing.assert_allclose(float(got["total"]), float(value), rtol=1e-5)
        assert got["logits"].shape == (SP_B, SP_L + fk - 1, 5)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("n", sorted(POS_CASES))
def test_raw_ctcnet_sp_positions_exact_in_float64(sp_runs, n):
    """With positions (global frame indices under SP), in float64: the
    gathered logits and the gradients of sum(w * logits) equal JAX's
    single device to 1e-10 (tests/test_seq_parallel_training.py's exact
    float64 check; the port's CTC is float32, so the objective here is
    linear in the logits)."""
    fk = POS_CASES[n]
    jax.config.update("jax_enable_x64", True)
    try:
        jnet, params, _, _ = _sp_nets(fk, True)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        x = jnp.asarray(_raw(SP_B, SP_L, 9), jnp.float64)
        w = jnp.asarray(_pos_weight(fk))
        logits = jax.jit(jnet.apply)(params, x)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(jnet.apply(p, x) * w)))(params)
        logits, grads = np.asarray(logits), _np_tree(grads)
    finally:
        jax.config.update("jax_enable_x64", False)
    # the JAX leaf of each port name (the bridge rounds values to float32)
    leaves, treedef = jax.tree_util.tree_flatten(grads)
    ids = bridge.raw_ctcnet_from_jax(jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(a), i, np.float32) for i, a in enumerate(leaves)]))
    want = {k: leaves[int(v.reshape(-1)[0])] for k, v in ids.items()}
    for out in sp_runs[n]:
        got = out[-1] if n == 4 else out[2]
        np.testing.assert_allclose(got["logits"].numpy(), logits, rtol=1e-10, atol=1e-10)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want[name], rtol=1e-10, atol=1e-10,
                                       err_msg=name)


@pytest.mark.parametrize("fk,n", [(4, 2), (3, 4)])
def test_raw_ctcnet_sp_needs_shards_to_divide_fk_minus_1(fk, n):
    """JAX's ValueError, raised before any collective."""
    _, _, tnet, tparams = _sp_nets(fk)
    tnet.load_state_dict(tparams)
    mesh = Mesh({"data": 1, "model": 1, "seq": n}, 0, torch.device("cpu"), {}, {})
    with pytest.raises(ValueError, match="feature_kwidth"), seq_axis(mesh):
        tnet(torch.zeros(1, 16, 1))


def _pair_jax():
    jm = jfacade.Model("raw-ctcnet", raw_cfg())
    return jm, jm.init(jax.random.PRNGKey(7))


@pytest.fixture(scope="module")
def pair_ref():
    """JAX's single-device objective, gradients and one Adamax step of the
    raw-ctcnet pair."""
    jm, params = _pair_jax()
    b = {k: jnp.asarray(v) for k, v in _pair_batch().items()}

    def loss(p):
        pred = jm.model_base.apply(p["base"], b["signal"])
        logits = jm.model_ctc.apply(p["ctc"], pred)
        return JJointLoss("ctc").calculate(b["signal"], pred, logits, b["labels"],
                                           b["label_lengths"])[1]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    want = bridge.param_tree_from_jax(_np_tree(grads))
    # the running statistics after one step: update_state from the old ones
    stats = jm.model_base.update_state(params["base"], params["base"], b["signal"])
    return float(value), want, stats


@pytest.mark.parametrize("mesh", sorted(PAIR_MESHES))
def test_raw_ctcnet_pair_on_dp_and_sp_matches_jax(sp_runs, pair_ref, mesh):
    """BatchNorm1d + RawCTCNet with JointLoss("ctc") on (data 2) and (seq
    2): BatchNorm's statistics are the global batch's, so the loss (rtol
    1e-5) and every gradient (rtol 1e-4, atol 1e-5) are JAX's single
    device's, and after one Adamax step every rank's running mean and var
    are JAX's update_state within 1e-6."""
    value, want, stats = pair_ref
    k = 3 + 2 * list(PAIR_MESHES).index(mesh)
    for r, out in enumerate(sp_runs[2]):
        vg, step = out[k], out[k + 1]
        np.testing.assert_allclose(float(vg["total"]), value, rtol=1e-5)
        for part in ("base", "ctc"):
            for name, g in vg["grads"][part].items():
                np.testing.assert_allclose(g.numpy(), want[part][name].numpy(), rtol=1e-4,
                                           atol=1e-5, err_msg=f"rank {r} {part}.{name}")
        for key in ("mean", "var"):
            np.testing.assert_allclose(step["params"]["base"][key].numpy(),
                                       np.asarray(stats[key]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {r} {key}")

"""The port's training slice (training/loss.py, optimizer.py, trainer.py,
bridge.train_state_from_jax) against the JAX package on the CPU: the
losses, every optimizer rule and schedule against optax for 3 steps, the
overflow-proof norm and clip at a 1e18 scale, the bridged train state, and
3 joint steps of a small model from bridged weights against JAX
``make_joint_train_step`` (f32; full length and length-aware; K=2 on one
batch), the skip guard on a NaN batch, and the eval step. Off the card the
guard's and the rules' list-wise calls (ops.multi_tensor) must give the
bits of the per-leaf operators they replaced, and never reach the CUDA
libraries.
Tolerance: rtol 1e-4 (atol 1e-6) for losses, metrics, states and params: f32
sums over frames, channels and blocks in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavenet_speech_tpu.models import WaveNet as JWaveNet
from wavenet_speech_tpu.models import WaveNetClassifier as JClassifier
from wavenet_speech_tpu.training import JointLoss as JJointLoss
from wavenet_speech_tpu.training import TrainState as JTrainState
from wavenet_speech_tpu.training import build_optimizer as j_build_optimizer
from wavenet_speech_tpu.training import make_eval_step as j_make_eval_step
from wavenet_speech_tpu.training import make_joint_train_step as j_make_joint_train_step
from wavenet_speech_tpu.training import make_lr_schedule as j_make_lr_schedule
from wavenet_speech_tpu.training import next_signal_xe_loss as j_xe
from wavenet_speech_tpu.training.trainer import all_finite as j_all_finite
from wavenet_speech_tpu.training.trainer import global_norm_safe as j_global_norm_safe
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.models import WaveNet, WaveNetClassifier
from wavenet_speech_tpu_torch.ops import _build, multi_tensor
from wavenet_speech_tpu_torch.training import (JointLoss, Optimizer, ReduceLROnPlateau,
                                               TrainState, build_optimizer, make_eval_step,
                                               make_joint_train_step, make_lr_schedule,
                                               next_signal_xe_loss, param_tree)
from wavenet_speech_tpu_torch.training.optimizer import apply_updates
from wavenet_speech_tpu_torch.training.trainer import all_finite, global_norm_safe
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-4, atol=1e-6)
C, LABELS, POOL, B, L, S = 16, 5, 4, 2, 64, 4


def _close(got, want, msg=""):
    g = [np.asarray(x.detach() if torch.is_tensor(x) else x) for x in tree_leaves(got)]
    w = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w), msg
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, err_msg=msg, **TOL)


# ---- losses -------------------------------------------------------------------

@pytest.mark.parametrize("lengths", [False, True])
def test_next_signal_xe_matches_jax(lengths):
    rng = np.random.default_rng(0)
    sig = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(3, 40))]
    pred = rng.standard_normal((3, 40, C)).astype(np.float32)
    lens = np.array([40, 25, 2], np.int32) if lengths else None
    got = next_signal_xe_loss(torch.from_numpy(sig), torch.from_numpy(pred),
                              None if lens is None else torch.from_numpy(lens))
    want = j_xe(jnp.asarray(sig), jnp.asarray(pred),
                None if lens is None else jnp.asarray(lens))
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("kw", [dict(), dict(averaged=False), dict(loss_choice="ctc"),
                                dict(ctc_weight=0.0, joint_weight=2.0)])
@pytest.mark.parametrize("length_aware", [False, True])
def test_joint_loss_matches_jax(kw, length_aware):
    rng = np.random.default_rng(1)
    sig = np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(B, L))]
    pred = rng.standard_normal((B, L, C)).astype(np.float32)
    logits = rng.standard_normal((B, L // POOL, LABELS)).astype(np.float32)
    labels = rng.integers(1, LABELS, size=(B, S)).astype(np.int32)
    lab = np.array([S, S - 1], np.int32)
    extra_j, extra_t = {}, {}
    if length_aware:
        lens = np.array([L, L - 13], np.int32)
        extra_j = dict(logit_lengths=jnp.asarray(lens // POOL), signal_lengths=jnp.asarray(lens))
        extra_t = dict(logit_lengths=torch.from_numpy(lens // POOL),
                       signal_lengths=torch.from_numpy(lens))
    want = JJointLoss(**kw).calculate(jnp.asarray(sig), jnp.asarray(pred), jnp.asarray(logits),
                                      jnp.asarray(labels), jnp.asarray(lab), **extra_j)
    got = JointLoss(**kw).calculate(torch.from_numpy(sig), torch.from_numpy(pred),
                                    torch.from_numpy(logits), torch.from_numpy(labels),
                                    torch.from_numpy(lab), **extra_t)
    assert (got[0] is None) == (want[0] is None)
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(float(g), float(w), **TOL)
    jt = JJointLoss(**kw).total(jnp.asarray(sig), jnp.asarray(pred), jnp.asarray(logits),
                                jnp.asarray(labels), jnp.asarray(lab), **extra_j)
    tt = JointLoss(**kw).total(torch.from_numpy(sig), torch.from_numpy(pred),
                               torch.from_numpy(logits), torch.from_numpy(labels),
                               torch.from_numpy(lab), **extra_t)
    np.testing.assert_allclose(float(tt), float(jt), **TOL)


# ---- optimizers -----------------------------------------------------------------

SCHED = {"warmup_cosine": dict(learning_rate=0.05, schedule="warmup_cosine",
                               warmup_steps=2, decay_steps=5),
         "warmup_constant": dict(learning_rate=0.05, schedule="warmup_constant",
                                 warmup_steps=2)}


def _tree(rng, scale=1.0):
    return {"b": (rng.standard_normal((4,)) * scale).astype(np.float32),
            "w": (rng.standard_normal((3, 4)) * scale).astype(np.float32)}


def _run_both(opt_kw, lr, grad_scale=1.0, steps=3):
    """3 updates of the port's and optax's chains on the same grads;
    returns (port params per step, JAX params per step)."""
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(steps)]
    jlr = j_make_lr_schedule(lr) if isinstance(lr, dict) else lr
    tlr = make_lr_schedule(lr) if isinstance(lr, dict) else lr
    jtx = j_build_optimizer(learning_rate=jlr, **opt_kw)
    ttx = build_optimizer(learning_rate=tlr, **opt_kw)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), tree_map(torch.from_numpy, p0)
    js, ts = jtx.init(jp), ttx.init(tp)
    out_t, out_j = [], []
    for g in grads:
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(tree_map(torch.from_numpy, g), ts, tp)
        tp = apply_updates(tp, tu)
        out_j.append(jp)
        out_t.append(tp)
    return out_t, out_j, ts, js


@pytest.mark.parametrize("optim_type", ["adam", "adamw", "adagrad", "adamax", "rmsprop", "sgd"])
@pytest.mark.parametrize("extra", ["plain", "clips", "warmup_cosine", "warmup_constant"])
def test_optimizer_rules_match_optax(optim_type, extra):
    kw = dict(optim_type=optim_type)
    lr = 0.05
    if extra == "clips":
        kw.update(max_grad_norm=0.5, max_update_norm=0.01,
                  weight_decay=0.1 if optim_type != "adamw" else None)
    elif extra in SCHED:
        lr = SCHED[extra]
    if optim_type == "adamw":
        kw["weight_decay"] = 0.1
    out_t, out_j, ts, js = _run_both(kw, lr)
    for i, (t, j) in enumerate(zip(out_t, out_j)):
        _close(t, j, f"{optim_type} {extra} step {i + 1}")
    _close(ts, js, "optimizer state")


def test_safe_clip_at_1e18_scale():
    """Finite gradients near 1e18: the safe clip keeps the update finite and
    nonzero (a naive norm reads inf and zeroes it), as in JAX."""
    out_t, out_j, _, _ = _run_both(dict(optim_type="sgd", max_grad_norm=1.0), 0.1,
                                   grad_scale=1e18)
    for t, j in zip(out_t, out_j):
        _close(t, j, "1e18 clip")
    moved = np.abs(out_t[-1]["w"].numpy() - _tree(np.random.default_rng(2))["w"]).max()
    assert np.isfinite(moved) and moved > 0


@pytest.mark.parametrize("case", ["1e18", "nan", "inf", "zeros", "finite", "1e19"])
def test_all_finite_and_global_norm_safe_match_jax(case):
    """A NaN leaf gives norm 0 in both (JAX's docstring says non-finite:
    its max is NaN and NaN > 0 is false); an inf leaf gives NaN in both.
    Finite leaves of |g| ~1e19, whose squares overflow f32, are finite."""
    rng = np.random.default_rng(4)
    tree = _tree(rng, {"1e18": 1e18, "1e19": 1e19}.get(case, 1.0))
    if case in ("nan", "inf"):
        tree["w"][1, 2] = np.nan if case == "nan" else np.inf
    if case == "zeros":
        tree = tree_map(np.zeros_like, tree)
    tt = tree_map(torch.from_numpy, tree)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    assert bool(all_finite(tt)) == bool(j_all_finite(jt)) == (case not in ("nan", "inf"))
    got, want = float(global_norm_safe(tt)), float(j_global_norm_safe(jt))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.isfinite(got) == (case != "inf")


# ---- the list-wise plain path (ops.multi_tensor off the card) -------------------

def _old_bias_correction(decay, count):
    return 1 - torch.pow(torch.tensor(decay, device=count.device), count.float())


def _old_global_norm_safe(leaves):
    absmax = torch.stack([l.abs().max() for l in leaves]).max()
    scale = torch.clamp(absmax, min=torch.finfo(torch.float32).tiny)
    ssq = sum([torch.sum((l / scale) ** 2) for l in leaves])
    return torch.where(absmax > 0, scale * torch.sqrt(ssq), 0.0)


def _mt_lists(values):
    rng = np.random.default_rng(7)
    shapes = [(4,), (3, 4), (2, 3, 5), (1,), (2, 7)]
    lists = [[torch.from_numpy(rng.standard_normal(sh).astype(np.float32)) for sh in shapes]
             for _ in range(4)]
    lists[2] = [x.abs() + 0.5 for x in lists[2]]   # second moments, sums: positive
    lists[3] = [x * 1e-3 for x in lists[3]]
    if values == "nonfinite":
        lists[0][1][1, 2], lists[0][2][0, 1, 3] = np.nan, np.inf
    if values == "zeros":
        lists[0] = [torch.zeros_like(x) for x in lists[0]]
    return lists


def _per_leaf(op, g, p, nu, m):
    """(list-wise call, the per-leaf operators the rules ran before it)."""
    c = torch.tensor(3, dtype=torch.int32)
    c1, c2 = _old_bias_correction(0.9, c), _old_bias_correction(0.999, c)
    ok = torch.tensor(op.endswith("skip") is False)
    scale = torch.clamp(torch.stack([x.abs().max() for x in g]).max(),
                        min=torch.finfo(torch.float32).tiny)
    if op == "absmax":
        return [multi_tensor.absmax(g)], [torch.stack([x.abs().max() for x in g])]
    if op == "sum_squares":
        return ([multi_tensor.sum_squares(g, scale)],
                [torch.stack([torch.sum((x / scale) ** 2) for x in g])])
    if op == "global_norm_safe":
        return [global_norm_safe({"g": g})], [_old_global_norm_safe(g)]
    if op == "all_finite":
        return ([all_finite({"g": g})],
                [torch.stack([torch.isfinite(x).all() for x in g]).all()])
    if op.startswith("select"):
        return (multi_tensor.select(ok, g) + multi_tensor.select(ok, g, p),
                [torch.where(ok, x, 0.0) for x in g] + [torch.where(ok, x, y)
                                                        for x, y in zip(g, p)])
    if op == "scale":
        lr = torch.tensor(-0.05)
        return (multi_tensor.scale(g, -0.05) + multi_tensor.scale(g, lr)
                + multi_tensor.scale(g, scale),
                [-0.05 * x for x in g] + [lr.to(x.dtype) * x for x in g]
                + [x * scale for x in g])
    if op == "add_scaled":
        return multi_tensor.add_scaled(g, p, 0.1), [x + 0.1 * y for x, y in zip(g, p)]
    if op == "add":
        return multi_tensor.add(p, g), [(y + x).to(y.dtype) for x, y in zip(g, p)]
    if op == "rss":
        ssq = [x * x + s for x, s in zip(g, nu)]
        return (sum(multi_tensor.rss(g, nu, 1e-7), []),
                [torch.where(s > 0, torch.rsqrt(s + 1e-7), 0.0) * x
                 for x, s in zip(g, ssq)] + ssq)
    if op == "rms":
        n2 = [(1 - 0.9) * (x ** 2) + 0.9 * n for x, n in zip(g, nu)]
        return (sum(multi_tensor.rms(g, nu, 0.9, 1e-8), []),
                [torch.rsqrt(n + 1e-8) * x for x, n in zip(g, n2)] + n2)
    if op == "adam":
        mu = [(1 - 0.9) * x + 0.9 * y for x, y in zip(g, m)]
        n2 = [(1 - 0.999) * (x ** 2) + 0.999 * n for x, n in zip(g, nu)]
        return (sum(multi_tensor.adam(g, m, nu, 0.9, 0.999, 1e-8, c1, c2), []),
                [(a / c1) / (torch.sqrt(b / c2) + 1e-8) for a, b in zip(mu, n2)] + mu + n2)
    if op == "adamax":
        mu = [(1 - 0.9) * x + 0.9 * y for x, y in zip(g, m)]
        n2 = [torch.maximum(torch.abs(x) + 1e-8, 0.999 * n) for x, n in zip(g, nu)]
        return (sum(multi_tensor.adamax(g, m, nu, 0.9, 0.999, 1e-8, c1), []),
                [(a / c1) / b for a, b in zip(mu, n2)] + mu + n2)
    raise ValueError(op)


MT_OPS = ["absmax", "sum_squares", "global_norm_safe", "all_finite", "select",
          "select_skip", "scale", "add_scaled", "add", "rss", "rms", "adam", "adamax"]


@pytest.mark.parametrize("values", ["finite", "nonfinite", "zeros"])
@pytest.mark.parametrize("op", MT_OPS)
def test_multi_tensor_plain_path_is_per_leaf_arithmetic(op, values):
    """Off the card each list-wise call gives the bits of the per-leaf
    operators the guard and the rules ran before it (NaN where they give
    NaN)."""
    got, want = _per_leaf(op, *_mt_lists(values))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b), op


def test_bias_correction_matches_the_host_tensor_form():
    """The bias correction, now with a number as pow's base, gives the bits
    it gave with a tensor made on the host."""
    from wavenet_speech_tpu_torch.training.optimizer import _bias_correction

    for decay in (0.9, 0.999):
        for c in (1, 2, 3, 10, 100, 12345, 2**31 - 1):
            count = torch.tensor(c, dtype=torch.int32)
            assert torch.equal(_bias_correction(decay, count),
                               _old_bias_correction(decay, count)), (decay, c)


def test_multi_tensor_layout():
    """The chunks and output offsets of a launch: every chunk has one owner
    (the leaf the kernel's binary search finds: the last whose first chunk
    is at or before it), empty leaves own none, outputs start on ALIGN."""
    C, A = multi_tensor.CHUNK, multi_tensor.ALIGN
    numel = np.array([0, 1, C, C + 1, 0, 3 * C - 5, 7, 0], np.int64)
    starts, offsets = multi_tensor.layout(numel)
    assert starts.tolist() == [0, 0, 1, 2, 4, 4, 7, 8, 8]
    for chunk in range(int(starts[-1])):
        leaf = int(np.searchsorted(starts[:-1], chunk, side="right")) - 1
        assert starts[leaf] <= chunk < starts[leaf + 1] and numel[leaf] > 0
    assert all(o % A == 0 for o in offsets)
    assert (offsets[1:] - offsets[:-1] >= numel).all()
    assert (offsets[1:] - offsets[:-1] < numel + A).all()


def test_cpu_steps_never_load_the_kernels(monkeypatch):
    """On the CPU every rule and the guard run the per-leaf arithmetic: no
    CUDA library is built or loaded, no kernel counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU step reached the CUDA libraries")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    before = multi_tensor.launches
    _, _, tnet, tclf, params = _models()
    for optim_type in ("adam", "adamw", "adagrad", "adamax", "rmsprop", "sgd"):
        tx = build_optimizer(optim_type, make_lr_schedule(SCHED["warmup_cosine"]),
                             max_grad_norm=1.0, max_update_norm=0.5)
        step = make_joint_train_step(tnet, tclf, tx)
        state, m = step(TrainState.create(bridge.param_tree_from_jax(params), tx), _batch())
        assert int(m["skipped_nonfinite"]) == 0
    assert multi_tensor.launches == before and "multi_tensor" not in _build._libs


def test_lr_schedules_match_optax():
    for cfg in SCHED.values():
        j, t = j_make_lr_schedule(cfg), make_lr_schedule(cfg)
        for c in range(8):
            np.testing.assert_allclose(float(t(torch.tensor(c, dtype=torch.int32))),
                                       float(j(jnp.asarray(c, jnp.int32))), **TOL)
    assert make_lr_schedule({"learning_rate": 0.3}) == 0.3
    with pytest.raises(ValueError):
        make_lr_schedule({"learning_rate": 0.3, "schedule": "bogus"})


def test_optimizer_facade_and_plateau():
    opt = Optimizer("sgd", 0.1)
    p = {"w": torch.ones(3)}
    s = opt.init(p)
    sched = ReduceLROnPlateau(opt, factor=0.5, patience=1)
    for metric in (1.0, 2.0, 2.0):
        sched.step(metric)
    assert sched.current_lr == pytest.approx(0.05)
    u, _ = opt.update({"w": torch.ones(3)}, s, p)
    torch.testing.assert_close(u["w"], torch.full((3,), -0.05))


# ---- the joint step ---------------------------------------------------------------

def _models():
    layers = tuple((C, C, 2, d) for d in (1, 2, 4, 8))
    clf_layers = tuple((C, C, 2, d) for d in (1, 2))
    jnet = JWaveNet(C, 2, layers, C, softmax=False)
    jclf = JClassifier(C, LABELS, clf_layers, C, pool_kernel_size=POOL, softmax=False)
    tnet = WaveNet(C, 2, layers, C, softmax=False, device="cpu")
    tclf = WaveNetClassifier(C, LABELS, clf_layers, C, pool_kernel_size=POOL,
                             softmax=False, device="cpu")
    params = {"base": jnet.init(jax.random.PRNGKey(0)), "ctc": jclf.init(jax.random.PRNGKey(1))}
    return jnet, jclf, tnet, tclf, params


def _batch(seed=5, levels=False):
    rng = np.random.default_rng(seed)
    lv = rng.integers(0, C, size=(B, L))
    return {"signal": lv.astype(np.int32) if levels else np.eye(C, dtype=np.float32)[lv],
            "labels": rng.integers(1, LABELS, size=(B, S)).astype(np.int32),
            "label_lengths": np.array([S, S - 1], np.int32),
            "signal_lengths": np.array([L, L - 9], np.int32)}


@pytest.mark.parametrize("mode", ["full", "length_aware", "k2_same_batch", "levels"])
def test_joint_steps_match_jax(mode):
    jnet, jclf, tnet, tclf, params = _models()
    jtx = j_build_optimizer("adagrad", 1e-2)
    ttx = build_optimizer("adagrad", 1e-2)
    kw = {}
    if mode == "length_aware":
        kw["logit_length_fn"] = lambda l: l // POOL
    if mode == "k2_same_batch":
        kw.update(steps_per_call=2, multi_same_batch=True)
    jstep = j_make_joint_train_step(jnet, jclf, jtx, JJointLoss("joint"), donate=False, **kw)
    tstep = make_joint_train_step(tnet, tclf, ttx, JointLoss("joint"), **kw)
    jstate = JTrainState.create(params, jtx)
    tstate = bridge.train_state_from_jax(jstate)
    batch = _batch(levels=mode == "levels")
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       err_msg=f"step {i + 1} {k}", **TOL)
    want = bridge.train_state_from_jax(jstate)
    for name in ("params", "opt_state"):
        for g, w in zip(tree_leaves(getattr(tstate, name)), tree_leaves(getattr(want, name))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)
    assert int(tstate.step) == int(jstate.step)


def test_nonfinite_batch_is_skipped():
    _, _, tnet, tclf, params = _models()
    tx = build_optimizer("adam", 1e-2)
    step = make_joint_train_step(tnet, tclf, tx)
    state = TrainState.create(bridge.param_tree_from_jax(params), tx)
    state, m = step(state, _batch())  # one good step: the state is not fresh
    assert int(m["skipped_nonfinite"]) == 0
    bad = _batch()
    bad["signal"][0, 3, :] = np.nan
    new, m = step(state, bad)
    assert int(m["skipped_nonfinite"]) == 1 and not np.isfinite(float(m["total_loss"]))
    assert int(new.step) == int(state.step) + 1
    for a, b in zip(tree_leaves((new.params, new.opt_state)),
                    tree_leaves((state.params, state.opt_state))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optim_type", ["adamw", "adagrad", "adamax", "rmsprop", "sgd"])
def test_skipped_step_keeps_each_rule_state(optim_type):
    """As above for the other rules, with both norm clips and a schedule: a
    skipped step leaves params and optimizer state bit for bit as they
    were."""
    _, _, tnet, tclf, params = _models()
    tx = build_optimizer(optim_type, make_lr_schedule(SCHED["warmup_cosine"]),
                         max_grad_norm=1.0, max_update_norm=0.5)
    step = make_joint_train_step(tnet, tclf, tx)
    state, _ = step(TrainState.create(bridge.param_tree_from_jax(params), tx), _batch())
    bad = _batch()
    bad["signal"][1, 5, :] = np.inf
    new, m = step(state, bad)
    assert int(m["skipped_nonfinite"]) == 1
    for a, b in zip(tree_leaves((new.params, new.opt_state)),
                    tree_leaves((state.params, state.opt_state))):
        assert torch.equal(a, b)


def test_eval_step_matches_jax():
    jnet, jclf, tnet, tclf, params = _models()
    fn = lambda l: l // POOL
    jm = j_make_eval_step(jnet, jclf, logit_length_fn=fn)(
        params, {k: jnp.asarray(v) for k, v in _batch().items()})
    tm = make_eval_step(tnet, tclf, logit_length_fn=fn)(bridge.param_tree_from_jax(params),
                                                        _batch())
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("optim_type", ["adam", "adamw", "adagrad", "adamax", "rmsprop", "sgd"])
def test_train_state_from_jax(optim_type):
    """A JAX TrainState after one step maps onto the port's state: the same
    structure as the port's own init, and the same leaves."""
    _, _, tnet, tclf, params = _models()
    jtx = j_build_optimizer(optim_type, j_make_lr_schedule(SCHED["warmup_cosine"]),
                            max_grad_norm=1.0)
    ttx = build_optimizer(optim_type, make_lr_schedule(SCHED["warmup_cosine"]),
                          max_grad_norm=1.0)
    jstate = JTrainState.create(params, jtx)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01), params)
    upd, opt_state = jtx.update(grads, jstate.opt_state, params)
    jstate = JTrainState(optax.apply_updates(params, upd), opt_state, jstate.step + 1)
    got = bridge.train_state_from_jax(jstate)
    own = TrainState.create(param_tree(tnet, tclf), ttx)
    assert (jax.tree_util.tree_structure(tree_map(lambda t: 0, got.opt_state))
            == jax.tree_util.tree_structure(tree_map(lambda t: 0, own.opt_state)))
    want = bridge._opt_state_from_jax(jstate.opt_state)
    for a, b in zip(tree_leaves(got.opt_state), tree_leaves(want)):
        assert torch.equal(a, b)
    assert int(got.step) == 1
    assert got.params["base"].keys() == own.params["base"].keys()

"""The port's CTC-only train step (training.make_ctc_train_step) and the
joint step on a raw-ctcnet pair (BatchNorm1d + RawCTCNet, JointLoss("ctc"),
BatchNorm's update_state hook) against the JAX package on the CPU, from
weights and Adamax state carried over by bridge.train_state_from_jax, for 3
steps (3 calls of 2 with steps_per_call=2): the metrics, the params (the
running mean and var included) and the optimizer state. Also a NaN batch,
which both skip while BatchNorm's running statistics still take it, as in
JAX. Tolerance: the metrics within rtol 1e-4, atol 1e-6, as the joint
step's tests (float32 sums over frames, channels and blocks in another
order); each element of the params and optimizer state within rtol 1e-4
plus 1e-4 of its leaf's largest magnitude, since an element whose
gradient nearly cancels carries the rounding of the leaf's largest terms
(measured worst: 3.2e-5 of the leaf's largest, in Adamax's mu)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu import facade as jfacade
from wavenet_speech_tpu.models import RawCTCNet as JRawCTCNet
from wavenet_speech_tpu.ops.norm import batch_standardize as j_batch_standardize
from wavenet_speech_tpu.training import JointLoss as JJointLoss
from wavenet_speech_tpu.training import TrainState as JTrainState
from wavenet_speech_tpu.training import build_optimizer as j_build_optimizer
from wavenet_speech_tpu.training import make_eval_step as j_make_eval_step
from wavenet_speech_tpu.training import make_joint_train_step as j_make_joint_train_step
from wavenet_speech_tpu.training.trainer import make_ctc_train_step as j_make_ctc_train_step
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.facade import Model
from wavenet_speech_tpu_torch.models import RawCTCNet
from wavenet_speech_tpu_torch.ops.norm import batch_standardize
from wavenet_speech_tpu_torch.training import (JointLoss, build_optimizer, make_eval_step,
                                               make_joint_train_step)
from wavenet_speech_tpu_torch.training.trainer import make_ctc_train_step
from wavenet_speech_tpu_torch.utils.tree import tree_leaves

TOL = dict(rtol=1e-4, atol=1e-6)
STATE_RTOL = 1e-4
F, LABELS, B, L, S, LR = 12, 5, 3, 60, 6, 1e-3
LAYERS = tuple((F, F, 3, d) for d in (1, 2)) * 2


def _batch(seed=5, k=None, picoamps=True):
    """Signals (B, L, 1), padded past signal_lengths: raw pico-amp-like
    (mean 80, std 8), or with picoamps=False at unit scale, what
    batch_standardize or BatchNorm hands RawCTCNet (raw pico-amps straight
    into the featurizer make its float32 gradients differ by ~1e-4 between
    any two summation orders). With k, k such batches stacked on a leading
    axis."""
    if k is not None:
        bs = [_batch(seed + i, picoamps=picoamps) for i in range(k)]
        return {f: np.stack([b[f] for b in bs]) for f in bs[0]}
    rng = np.random.default_rng(seed)
    lens = np.array([L, L - 7, L - 13], np.int32)
    sig = rng.standard_normal((B, L, 1)).astype(np.float32)
    if picoamps:
        sig = sig * 8 + 80
    sig[np.arange(L)[None, :] >= lens[:, None]] = 0.0
    return {"signal": sig, "labels": rng.integers(1, LABELS, size=(B, S)).astype(np.int32),
            "label_lengths": np.array([S, S - 1, S - 3], np.int32), "signal_lengths": lens}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_states_close(tstate, jstate, msg=""):
    want = bridge.train_state_from_jax(jstate)
    for name in ("params", "opt_state"):
        got, ref = tree_leaves(getattr(tstate, name)), tree_leaves(getattr(want, name))
        assert len(got) == len(ref)
        for g, w in zip(got, ref):
            scale = np.nanmax(np.abs(w.numpy()), initial=0.0)
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"{msg} {name}",
                                       rtol=STATE_RTOL, atol=STATE_RTOL * scale)
    assert int(tstate.step) == int(jstate.step)


def _assert_metrics_close(tm, jm, msg):
    assert sorted(tm) == sorted(jm), msg
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), err_msg=f"{msg} {k}",
                                   **TOL)


MODES = {
    "plain": {},
    "preprocess": {"preprocess": True},
    "summed": {"average_per_logit": False},
    "logit_lengths": {"use_logit_lengths": True},
    "k2_same_batch": {"steps_per_call": 2, "multi_same_batch": True},
    "k2_stacked": {"steps_per_call": 2, "multi_same_batch": False},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_ctc_steps_match_jax(mode):
    kw = dict(MODES[mode])
    jnet = JRawCTCNet(F, 3, LABELS, LAYERS, F, softmax=False)
    tnet = RawCTCNet(F, 3, LABELS, LAYERS, F, softmax=False, device="cpu")
    jkw, tkw = dict(kw), dict(kw)
    picoamps = kw.pop("preprocess", False)
    if picoamps:
        jkw["preprocess"], tkw["preprocess"] = j_batch_standardize, batch_standardize
    if kw.get("use_logit_lengths"):
        jkw["length_fn"], tkw["length_fn"] = jnet.output_length, tnet.output_length
    jtx, ttx = j_build_optimizer("adamax", LR), build_optimizer("adamax", LR)
    jstep = j_make_ctc_train_step(jnet, jtx, donate=False, **jkw)
    tstep = make_ctc_train_step(tnet, ttx, **tkw)
    jstate = JTrainState.create(jnet.init(jax.random.PRNGKey(0)), jtx)
    tstate = bridge.train_state_from_jax(jstate)
    k = 2 if kw.get("steps_per_call") == 2 and not kw["multi_same_batch"] else None
    for i in range(3):
        batch = _batch(5 + 10 * i, k, picoamps)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, batch)
        _assert_metrics_close(tm, jm, f"call {i + 1}")
        assert int(tm["skipped_nonfinite"].sum()) == 0
    _assert_states_close(tstate, jstate, mode)
    assert int(tstate.step) == 3 * kw.get("steps_per_call", 1)


def test_ctc_step_skips_a_nan_batch_as_jax():
    jnet = JRawCTCNet(F, 3, LABELS, LAYERS, F, softmax=False)
    tnet = RawCTCNet(F, 3, LABELS, LAYERS, F, softmax=False, device="cpu")
    jtx, ttx = j_build_optimizer("adamax", LR), build_optimizer("adamax", LR)
    jstep = j_make_ctc_train_step(jnet, jtx, donate=False)
    tstep = make_ctc_train_step(tnet, ttx)
    jstate = JTrainState.create(jnet.init(jax.random.PRNGKey(1)), jtx)
    tstate = bridge.train_state_from_jax(jstate)
    jstate, _ = jstep(jstate, _jax(_batch(picoamps=False)))
    tstate, _ = tstep(tstate, _batch(picoamps=False))
    bad = _batch(6, picoamps=False)
    bad["signal"][1, 4, 0] = np.nan
    before = tstate
    jstate, jm = jstep(jstate, _jax(bad))
    tstate, tm = tstep(tstate, bad)
    _assert_metrics_close(tm, jm, "nan batch")
    assert int(tm["skipped_nonfinite"]) == 1 and not np.isfinite(float(tm["total_loss"]))
    for a, b in zip(tree_leaves((tstate.params, tstate.opt_state)),
                    tree_leaves((before.params, before.opt_state))):
        assert torch.equal(a, b)
    _assert_states_close(tstate, jstate, "nan batch")


def _raw_cfg():
    return {"model": {"type": "raw-ctcnet",
                      "raw": {"num_features": F, "feature_kwidth": 3, "num_labels": LABELS,
                              "num_dilation_blocks": 2, "kernel": 3, "dilations": [1, 2],
                              "out_dim": F, "causal": False}}}


@pytest.mark.parametrize("length_aware", [False, True])
def test_raw_ctcnet_joint_steps_match_jax(length_aware):
    """The joint step on Model("raw-ctcnet") with JointLoss("ctc"): the
    train form of BatchNorm, then update_state from the pre-update leaves;
    3 steps, then a NaN batch (skipped; the running statistics still take
    it, in JAX and here), then the eval step on the running statistics."""
    jm_ = jfacade.Model("raw-ctcnet", _raw_cfg())
    tm_ = Model("raw-ctcnet", _raw_cfg(), device="cpu")
    jtx, ttx = j_build_optimizer("adamax", LR), build_optimizer("adamax", LR)
    jfn = jm_.model_ctc.output_length if length_aware else None
    tfn = tm_.output_length if length_aware else None
    jstep = j_make_joint_train_step(jm_.model_base, jm_.model_ctc, jtx, JJointLoss("ctc"),
                                    donate=False, logit_length_fn=jfn)
    tstep = make_joint_train_step(tm_.model_base, tm_.model_ctc, ttx, JointLoss("ctc"),
                                  logit_length_fn=tfn)
    jstate = JTrainState.create(jm_.init(jax.random.PRNGKey(2)), jtx)
    tstate = bridge.train_state_from_jax(jstate)
    for i in range(3):
        batch = _batch(20 + i)
        jstate, jm = jstep(jstate, _jax(batch))
        tstate, tm = tstep(tstate, batch)
        _assert_metrics_close(tm, jm, f"step {i + 1}")
    _assert_states_close(tstate, jstate, "3 steps")
    base = tstate.params["base"]
    assert float(base["mean"]) > 10 and float(base["var"]) > 10  # moved from (0, 1)

    # the eval step reads the running statistics
    jev = j_make_eval_step(jm_.eval_base(), jm_.model_ctc, JJointLoss("ctc"),
                           logit_length_fn=jfn)(jstate.params, _jax(_batch(30)))
    tev = make_eval_step(tm_.eval_base(), tm_.model_ctc, JointLoss("ctc"),
                         logit_length_fn=tfn)(tstate.params, _batch(30))
    _assert_metrics_close(tev, jev, "eval")
    train_form = make_eval_step(tm_.model_base, tm_.model_ctc, JointLoss("ctc"),
                                logit_length_fn=tfn)(tstate.params, _batch(30))
    assert not np.isclose(float(train_form["total_loss"]), float(tev["total_loss"]))

    bad = _batch(24)
    bad["signal"][0, 2, 0] = np.nan
    jstate, jm = jstep(jstate, _jax(bad))
    tstate, tm = tstep(tstate, bad)
    _assert_metrics_close(tm, jm, "nan batch")
    assert int(tm["skipped_nonfinite"]) == 1
    assert np.isnan(float(tstate.params["base"]["mean"]))  # as JAX's update_state
    _assert_states_close(tstate, jstate, "nan batch")


def test_batchnorm_base_takes_a_data_parallel_mesh():
    """The raw-ctcnet pair's step builds on a mesh of 2 data ranks, which
    it refused before BatchNorm's statistics were taken over the ranks
    (trained on 2 ranks in tests/test_torch_raw_ctcnet.py), and outside
    ``batch_stats`` BatchNorm's statistics stay this rank's batch's."""
    class TwoRanks:
        size = 2

        def axis_size(self, name):
            return 2 if name == "data" else 1

    m = Model("raw-ctcnet", _raw_cfg(), device="cpu").init(0)
    make_joint_train_step(m.model_base, m.model_ctc, build_optimizer("adam", 1e-3),
                          JointLoss("ctc"), mesh=TwoRanks())
    x = torch.from_numpy(_batch(3)["signal"])
    with torch.no_grad():
        want = (x - x.mean()) / torch.sqrt(x.var(unbiased=False) + 1e-5)
        np.testing.assert_allclose(m.model_base(x).numpy(), want.numpy(), rtol=1e-5, atol=1e-5)

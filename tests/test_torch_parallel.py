"""The port's multi-device layer (wavenet_speech_tpu_torch/parallel/) and the
DP/SP train step against the JAX package on the CPU. The torch side runs on
gloo ranks spawned by ``run_ranks`` (each call with a timeout); the JAX
side in this process on the conftest's 8 virtual devices.

Cases: the mesh's rank layout against JAX ``make_mesh``; ``halo_pad`` and
its gradient against JAX ``halo_pad`` under ``shard_map`` (left, right,
both) and the error for a halo past the shard; the residual blocks under
SP (the causal one on B4/B5's plain versions over the halo window) against
the JAX composite under SP; the joint loss and gradients of a 16-channel
model (dilations 1..8, pool 4, L=128, B=4) on (data=1, seq=2) and (data=2,
seq=2) against JAX's single-device ``value_and_grad``; one Adagrad step on
data=2 and on data=2 x seq=2 against the JAX step; the single-process
helpers; ``run_ranks``'s failure and timeout reports.
Tolerance: rtol 1e-5 for losses and forward values, rtol 1e-4 and atol
1e-6 for gradients (f32 sums in another order, as __graft_entry__.py's
dry run), 1e-5 for the params after a step."""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from wavenet_speech_tpu.models import WaveNet as JWaveNet
from wavenet_speech_tpu.models import WaveNetClassifier as JClassifier
from wavenet_speech_tpu.models.blocks import ResidualBlock as JBlock
from wavenet_speech_tpu.parallel import make_mesh as j_make_mesh
from wavenet_speech_tpu.parallel import seq_sharded_apply as j_seq_sharded_apply
from wavenet_speech_tpu.parallel.halo import halo_pad as j_halo_pad
from wavenet_speech_tpu.training import JointLoss as JJointLoss
from wavenet_speech_tpu.training import TrainState as JTrainState
from wavenet_speech_tpu.training import build_optimizer as j_build_optimizer
from wavenet_speech_tpu.training import make_joint_train_step as j_make_joint_train_step
from wavenet_speech_tpu_torch import bridge
from wavenet_speech_tpu_torch.models import WaveNet, WaveNetClassifier
from wavenet_speech_tpu_torch.models.blocks import ResidualBlock
from wavenet_speech_tpu_torch.models.classifier import avg_pool1d
from wavenet_speech_tpu_torch.parallel import (halo_pad, initialize_multihost, is_primary,
                                               local_batch_slice, make_mesh, run_ranks,
                                               seq_axis, shard_batch, shard_params)
from wavenet_speech_tpu_torch.training import make_eval_step
from wavenet_speech_tpu_torch.utils.tree import tree_leaves

import torch_rank_programs

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
TIMEOUT = 180.0
C, LABELS, POOL, B, L, S = 16, 5, 4, 4, 128, 6


def _ranks(fn, data, seq, *args):
    return run_ranks(fn, data * seq, "gloo", (data, seq), *args, timeout=TIMEOUT)


# ---- the mesh and the single-process helpers -------------------------------------

@pytest.mark.parametrize("data,seq", [(2, 2), (1, 4), (4, 1)])
def test_mesh_places_ranks_as_jax(data, seq):
    out = _ranks(torch_rank_programs.mesh_layout, data, seq)
    ids = np.vectorize(lambda d: d.id)(j_make_mesh(data=data, model=1, seq=seq).devices)
    for r, layout in enumerate(out):
        assert tuple(layout["coords"]) == tuple(np.argwhere(ids == r)[0])
        d, m, s = layout["coords"]
        assert layout["lines"] == {"data": ids[:, m, s].tolist(), "model": ids[d, :, s].tolist(),
                                   "seq": ids[d, m, :].tolist()}


def test_single_process_helpers(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_multihost() is False
    assert initialize_multihost("tcp://127.0.0.1:1", world_size=1, rank=0) is False
    assert is_primary() and local_batch_slice(8) == slice(0, 8)
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.shape, mesh.line("seq")) == (1, {"data": 1, "model": 1, "seq": 1}, [0])
    params = {"a": {"w": torch.ones(2, 3)}}
    placed = shard_params(mesh, params)
    assert torch.equal(placed["a"]["w"], params["a"]["w"])
    assert placed["a"]["w"] is not params["a"]["w"]
    batch = shard_batch(mesh, {"signal": np.zeros((4, 8, 2)), "labels": np.ones((4, 3))},
                        seq_keys=("signal",))
    assert batch["signal"].shape == (4, 8, 2) and batch["labels"].shape == (4, 3)
    whole = shard_params(mesh, params, model_parallel=True)   # a model axis of 1
    assert torch.equal(whole["a"]["w"], params["a"]["w"])
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(data=2, device="cpu")


def test_model_axis_trains():
    """A (data 1, model 2) mesh trains: one joint Adagrad step (length
    aware) with the params TP-sharded (each rank keeps half of every leaf
    whose last dim divides) equals JAX's single-device step within 1e-5,
    the ranks' gathered params are equal to the bit, and the eval step on
    the TP state gives the single-device eval step's metrics."""
    params, want, jm = _jax_adagrad_step()
    base, clf = _torch_models()
    whole = bridge.param_tree_from_jax(params)
    out = run_ranks(torch_rank_programs.joint_train_steps, 2, "gloo", (1, 2, 1), base, clf,
                    whole, _batch(), "adagrad", 1e-2, 1, POOL, timeout=TIMEOUT)
    w = whole["base"]["stack.blocks.0.gate_w"]
    assert out[0]["local_shapes"]["base"]["stack.blocks.0.gate_w"] == (*w.shape[:-1],
                                                                        w.shape[-1] // 2)
    for a, b in zip(tree_leaves(out[1]["params"]), tree_leaves(out[0]["params"])):
        assert torch.equal(a, b)
    for k, v in out[0]["metrics"][0].items():
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for part in ("base", "ctc"):
        for name, p in out[0]["params"][part].items():
            np.testing.assert_allclose(p.numpy(), want[part][name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{part}.{name}")
    single = make_eval_step(base, clf, logit_length_fn=lambda l: l // POOL)(
        out[0]["params"], _batch())
    for k, v in single.items():
        for o in out:
            np.testing.assert_allclose(float(o["eval"][k]), float(v), rtol=1e-6, err_msg=k)


def test_pool_needs_whole_windows_in_a_shard():
    x = torch.zeros(1, 10, 2)
    assert avg_pool1d(x, 4).shape == (1, 2, 2)     # unsharded: floor, as in JAX
    with seq_axis(make_mesh(device="cpu")):
        assert avg_pool1d(x[:, :8], 4).shape == (1, 2, 2)
        with pytest.raises(ValueError, match="multiple of the pool"):
            avg_pool1d(x, 4)


# ---- run_ranks ---------------------------------------------------------------------

def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank . failed"):
        run_ranks(torch_rank_programs.mesh_layout, 2, "gloo", (3, 1), timeout=TIMEOUT)


def test_run_ranks_times_out():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        run_ranks(time.sleep, 2, "gloo", 60, timeout=10.0)
    assert time.monotonic() - t0 < 40


# ---- halo exchange -----------------------------------------------------------------

@pytest.mark.parametrize("left,right", [(3, 0), (0, 5), (4, 2), (8, 8)])
def test_halo_pad_matches_jax(left, right):
    """Values and d sum(w * padded) / d x on seq=4 shards of 8 frames."""
    seq, Ls = 4, 8
    rng = np.random.default_rng(left * 10 + right)
    x = rng.standard_normal((2, seq * Ls, 3)).astype(np.float32)
    w = rng.standard_normal((2, seq * (Ls + left + right), 3)).astype(np.float32)
    spec = P(None, "seq", None)
    f = shard_map(lambda xs: j_halo_pad(xs, left, right, "seq"),
                  mesh=j_make_mesh(data=1, model=1, seq=seq), in_specs=spec, out_specs=spec,
                  check_vma=False)
    y_j, vjp = jax.vjp(f, jnp.asarray(x))
    g_j, = vjp(jnp.asarray(w))
    out = _ranks(torch_rank_programs.halo_pad_value_and_grad, 1, seq, x, left, right, w)
    np.testing.assert_allclose(np.concatenate([o[0].numpy() for o in out], axis=1),
                               np.asarray(y_j), **VAL)
    np.testing.assert_allclose(np.concatenate([o[1].numpy() for o in out], axis=1),
                               np.asarray(g_j), **GRAD)


def test_halo_past_the_shard_raises_as_in_jax():
    x = np.zeros((1, 4, 2), np.float32)   # shards of 2 frames
    f = shard_map(lambda xs: j_halo_pad(xs, 3, 0, "seq"),
                  mesh=j_make_mesh(data=1, model=1, seq=2), in_specs=P(None, "seq", None),
                  out_specs=P(None, "seq", None), check_vma=False)
    with pytest.raises(ValueError, match="exceeds sequence shard length"):
        f(jnp.asarray(x))
    with pytest.raises(ValueError, match="exceeds sequence shard length 2"):
        halo_pad(torch.zeros(1, 2, 2), 3, 0, make_mesh(device="cpu"))


# ---- the residual blocks under SP --------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [1, 32])
def test_block_under_sp_matches_jax_composite(causal, d):
    """seq=2 shards of 32 frames; d=32 makes the causal halo a whole
    shard. The causal block runs the fused block's plain version on the
    window [halo | shard] (on the card: B4 and B5); JAX runs its composite
    (residual_block.py:113-121). Outputs and the gradients of x and of the
    block's params. The params' gradients sum 128 frames of O(1) products,
    whose cancellation leaves small elements with the absolute error of
    the sum: their atol is 1e-6 x max|g|."""
    seq, C_in, Co = 2, 12, 8
    jblk = JBlock(C_in, Co, 2, d, causal=causal)
    params = jblk.init(jax.random.PRNGKey(d))
    tblk = ResidualBlock(C_in, Co, 2, d, causal=causal, device="cpu")
    tblk.load_state_dict(bridge._block(jax.tree_util.tree_map(np.asarray, params), ""))
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 64, C_in)).astype(np.float32)
    wr, ws = (rng.standard_normal((2, 64, Co)).astype(np.float32) for _ in range(2))
    jmesh = j_make_mesh(data=1, model=1, seq=seq)

    def obj(p, xx):
        r, s = j_seq_sharded_apply(jblk.apply, jmesh, p, xx, data_sharded=False)
        return jnp.sum(r * wr) + jnp.sum(s * ws), (r, s)

    (_, (r_j, s_j)), (gp_j, gx_j) = jax.value_and_grad(obj, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    out = _ranks(torch_rank_programs.block_value_and_grad, 1, seq, tblk, x, (wr, ws))
    cat = lambda k: np.concatenate([o[k].numpy() for o in out], axis=1)
    np.testing.assert_allclose(cat(0), np.asarray(r_j), **VAL)
    np.testing.assert_allclose(cat(1), np.asarray(s_j), **VAL)
    np.testing.assert_allclose(cat(2), np.asarray(gx_j), **GRAD)
    want = bridge._block(jax.tree_util.tree_map(np.asarray, gp_j), "")
    for (name, _), g in zip(tblk.named_parameters(), out[0][3]):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD["rtol"],
                                   atol=GRAD["atol"] * np.abs(w).max(), err_msg=name)


# ---- the joint objective and the train step ---------------------------------------

def _jax_models():
    layers = tuple((C, C, 2, d) for d in (1, 2, 4, 8))
    clf_layers = tuple((C, C, 2, d) for d in (1, 2))
    jnet = JWaveNet(C, 2, layers, C, softmax=False)
    jclf = JClassifier(C, LABELS, clf_layers, C, pool_kernel_size=POOL, softmax=False)
    params = {"base": jnet.init(jax.random.PRNGKey(0)), "ctc": jclf.init(jax.random.PRNGKey(1))}
    return jnet, jclf, params


def _torch_models():
    base = WaveNet(C, 2, tuple((C, C, 2, d) for d in (1, 2, 4, 8)), C, softmax=False,
                   device="cpu")
    clf = WaveNetClassifier(C, LABELS, tuple((C, C, 2, d) for d in (1, 2)), C,
                            pool_kernel_size=POOL, softmax=False, device="cpu")
    return base, clf


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return {"signal": np.eye(C, dtype=np.float32)[rng.integers(0, C, size=(B, L))],
            "labels": rng.integers(1, LABELS, size=(B, S)).astype(np.int32),
            "label_lengths": np.array([S, S - 1, 4, S], np.int32),
            # 70 ends inside the first of two shards, 100 inside the second
            "signal_lengths": np.array([L, 100, 70, L], np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(length_aware):
    jnet, jclf, params = _jax_models()
    bt = {k: jnp.asarray(v) for k, v in _batch().items()}
    kw = {}
    if length_aware:
        kw = dict(logit_lengths=bt["signal_lengths"] // POOL,
                  signal_lengths=bt["signal_lengths"])

    def loss(p):
        pred = jnet.apply(p["base"], bt["signal"])
        logits = jclf.apply(p["ctc"], pred)
        xe, ctc = JJointLoss("joint").calculate(bt["signal"], pred, logits, bt["labels"],
                                                bt["label_lengths"], **kw)
        return xe + ctc, (xe, ctc)

    (total, (xe, ctc)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return params, float(total), float(xe), float(ctc), bridge.param_tree_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("length_aware", [False, True])
@pytest.mark.parametrize("data,seq", [(1, 2), (2, 2)])
def test_sp_joint_loss_and_grads_match_jax(data, seq, length_aware):
    params, total, xe, ctc, grads = _jax_value_and_grad(length_aware)
    base, clf = _torch_models()
    out = _ranks(torch_rank_programs.joint_value_and_grad, data, seq, base, clf,
                 bridge.param_tree_from_jax(params), _batch(), POOL if length_aware else None)
    for r, o in enumerate(out):
        for k, want in (("total", total), ("xe", xe), ("ctc", ctc)):
            np.testing.assert_allclose(float(o[k]), want, rtol=1e-5, err_msg=f"rank {r} {k}")
        for part in ("base", "ctc"):
            for name, g in o["grads"][part].items():
                np.testing.assert_allclose(g.numpy(), grads[part][name].numpy(),
                                           err_msg=f"rank {r} {part}.{name}", **GRAD)


@functools.lru_cache(maxsize=None)
def _jax_adagrad_step():
    """JAX's single-device joint Adagrad step, length-aware: its params
    before (JAX's tree), after (the port's tree) and its metrics."""
    jnet, jclf, params = _jax_models()
    jtx = j_build_optimizer("adagrad", 1e-2)
    jstep = j_make_joint_train_step(jnet, jclf, jtx, JJointLoss("joint"), donate=False,
                                    logit_length_fn=lambda l: l // POOL)
    jstate, jm = jstep(JTrainState.create(params, jtx),
                       {k: jnp.asarray(v) for k, v in _batch().items()})
    return (params, bridge.param_tree_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params)),
            {k: float(v) for k, v in jm.items()})


@pytest.mark.parametrize("data,seq", [(2, 1), (2, 2)])
def test_adagrad_step_matches_jax(data, seq):
    """One joint Adagrad step, length-aware, on data=2 (DP) and data=2 x
    seq=2: the params of every rank equal each other bit for bit and the
    JAX step's within 1e-5; the metrics within 1e-5."""
    params, want, jm = _jax_adagrad_step()
    base, clf = _torch_models()
    out = _ranks(torch_rank_programs.joint_train_steps, data, seq, base, clf,
                 bridge.param_tree_from_jax(params), _batch(), "adagrad", 1e-2, 1, POOL)
    for o in out[1:]:
        for a, b in zip(tree_leaves(o["params"]), tree_leaves(out[0]["params"])):
            assert torch.equal(a, b)
    for k, v in out[0]["metrics"][0].items():
        np.testing.assert_allclose(float(v), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for part in ("base", "ctc"):
        for name, p in out[0]["params"][part].items():
            np.testing.assert_allclose(p.numpy(), want[part][name].numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{part}.{name}")

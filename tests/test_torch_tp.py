"""Tensor parallelism over the "model" axis (wavenet_speech_tpu_torch/
parallel/sharding.py) and the port's multi-device dry run, against the JAX
package on the CPU.

Cases: ``param_shardings`` gives JAX's spec for every leaf of a tiny
RawCTCNet on (data 2, model 4), and ``local_slices`` (what
``shard_params(model_parallel=True)`` keeps) each rank JAX's addressable
shard; on 4 gloo ranks, (data 2, model 2): the TP forward equals JAX's
replicated forward (tests/test_parallel.py's rtol 1e-4, atol 1e-5), 3
Adam steps of ``make_ctc_train_step`` equal JAX's step on its inputs
sharded over (data 2, model 2), a single-device checkpoint restores into the TP state and the TP
state's checkpoint on one device, both bit for bit, and 3 steps whose
update is clipped by the whole tree's norm (``build_optimizer(...,
max_update_norm)``; the step sets the norm, ``optimizer.clip_norm``)
equal JAX's; on 2 ranks, (data 2):
the same 3 steps; and ``graft_entry.dryrun_multichip(8)`` on the CPU.
Tolerance of the steps: the metrics within rtol 1e-4; the params within
rtol 1e-4 and atol 1e-7 (Adam's first steps move each weight by about the
learning rate, 1e-3, whatever its gradient's size, so an element whose
gradient nearly cancels takes the sign of float32 rounding: measured
worst 2.4e-8 from JAX's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_speech_tpu.models import RawCTCNet as JRawCTCNet
from wavenet_speech_tpu.parallel import make_mesh as j_make_mesh
from wavenet_speech_tpu.parallel import param_shardings as j_param_shardings
from wavenet_speech_tpu.parallel import shard_batch as j_shard_batch
from wavenet_speech_tpu.parallel import shard_params as j_shard_params
from wavenet_speech_tpu.training import TrainState as JTrainState
from wavenet_speech_tpu.training import build_optimizer as j_build_optimizer
from wavenet_speech_tpu.training import make_ctc_train_step as j_make_ctc_train_step
from wavenet_speech_tpu_torch import bridge, graft_entry
from wavenet_speech_tpu_torch.models import RawCTCNet
from wavenet_speech_tpu_torch.parallel import param_shardings, run_ranks
from wavenet_speech_tpu_torch.parallel.mesh import Mesh
from wavenet_speech_tpu_torch.parallel.sharding import local_slices
from wavenet_speech_tpu_torch.training import TrainState, build_optimizer
from wavenet_speech_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from wavenet_speech_tpu_torch.utils.tree import tree_leaves

import torch_rank_programs

TIMEOUT = 180.0
STEP_TOL = dict(rtol=1e-4, atol=1e-7)
B, L, STEPS = 8, 32, 3


def _layers(F):
    return tuple((F, F, 3, d) for d in (1, 2, 4))


def _jax_net(F):
    return JRawCTCNet(F, 3, 5, _layers(F), F, softmax=False)


def _torch_net(F):
    return RawCTCNet(F, 3, 5, _layers(F), F, softmax=False, device="cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    """tests/test_parallel.py's batch."""
    rng = np.random.default_rng(seed)
    return {"signal": rng.standard_normal((B, L, 1)).astype(np.float32),
            "labels": rng.integers(1, 5, size=(B, 6)).astype(np.int32),
            "label_lengths": np.full((B,), 6, np.int32),
            "signal_lengths": np.full((B,), L, np.int32)}


def _fake_mesh(shape, rank):
    """This rank's view of a mesh, for the functions that need no
    collective."""
    return Mesh(dict(zip(("data", "model", "seq"), shape)), rank, torch.device("cpu"), {}, {})


def _jax_leaf_of(params):
    """The port's leaf name -> the JAX leaf it comes from (the bridge run
    on leaves filled with their index)."""
    jleaves, treedef = jax.tree_util.tree_flatten(params)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(jleaves)])
    return {k: jleaves[int(v.reshape(-1)[0])] for k, v in bridge.raw_ctcnet_from_jax(ids).items()}


def _port_spec(spec, ndim):
    return () if spec is None else (None,) * spec + ("model",) + (None,) * (ndim - spec - 1)


def test_param_shardings_and_slices_match_jax():
    """(data 2, model 4), 32 features: every leaf's spec is JAX's, and each
    rank's slice is the shard JAX places on that device."""
    jmesh = j_make_mesh(data=2, model=4)
    params = _jax_net(32).init(jax.random.PRNGKey(1))
    jspecs = j_param_shardings(jmesh, params, model_parallel=True)
    jsharded = j_shard_params(jmesh, params, model_parallel=True)
    spec_of = _jax_leaf_of(jspecs)
    leaf_of = _jax_leaf_of(jsharded)
    whole = bridge.raw_ctcnet_from_jax(_np(params))
    specs = param_shardings(_fake_mesh((2, 4, 1), 0), whole, model_parallel=True)
    assert set(specs) == set(spec_of)
    assert any(s is not None for s in specs.values()) and any(s is None for s in specs.values())
    for name, spec in specs.items():
        assert _port_spec(spec, whole[name].dim()) == tuple(spec_of[name].spec), name
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):
        local = local_slices(_fake_mesh((2, 4, 1), rank), whole, specs)
        for name, t in local.items():
            shard, = [s.data for s in leaf_of[name].addressable_shards
                      if s.device.id == int(ids.reshape(-1)[rank])]
            np.testing.assert_array_equal(t.numpy(), np.asarray(shard), err_msg=name)


CLIP = 1e-2   # max_update_norm: below the first updates' norm (~0.1)


def _jax_steps(max_update_norm=None):
    """JAX's make_ctc_train_step, 3 Adam steps on its inputs sharded over
    (data 2, model 2); JAX's global view gives any mesh these numbers."""
    jmesh = j_make_mesh(data=2, model=2)
    params = _jax_net(16).init(jax.random.PRNGKey(0))
    tx = j_build_optimizer("adam", 1e-3, max_update_norm=max_update_norm)
    step = j_make_ctc_train_step(_jax_net(16), tx, donate=False)
    state = JTrainState.create(j_shard_params(jmesh, params, model_parallel=True), tx)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, j_shard_batch(jmesh, _batch()))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def jax_steps():
    return _jax_steps()


def _assert_steps_match(out, jstate, jmetrics):
    want = bridge.raw_ctcnet_from_jax(_np(jstate.params))
    for r, o in enumerate(out):
        for m, jm in zip(o["metrics"], jmetrics):
            for k in ("ctc_loss", "grad_norm", "skipped_nonfinite"):
                np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-4, err_msg=f"rank {r} {k}")
        for name, p in o["params"].items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), err_msg=f"rank {r} {name}",
                                       **STEP_TOL)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(o["params"]),
                                                    tree_leaves(out[0]["params"])))


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """4 ranks on (data 2, model 2): the TP forward, the single-device
    checkpoint restored into the TP state, 3 steps, the TP checkpoint."""
    tmp = tmp_path_factory.mktemp("tp")
    params = _jax_net(16).init(jax.random.PRNGKey(0))
    whole = bridge.raw_ctcnet_from_jax(_np(params))
    tx = build_optimizer("adam", 1e-3)
    one = TrainState.create(whole, tx)
    one.opt_state[0][0]["mu"]["out1.w"].normal_(generator=torch.Generator().manual_seed(1))
    save_checkpoint(str(tmp / "one"), one, step=5)
    rp = torch_rank_programs
    out = run_ranks(rp.several, 4, "gloo", [
        (rp.ctc_train_steps, ((2, 2, 1), _torch_net(16), whole, _batch(), STEPS,
                              str(tmp / "one"), str(tmp / "tp"))),
        (rp.ctc_train_steps, ((2, 2, 1), _torch_net(16), whole, _batch(), STEPS, None, None,
                              CLIP)),
        (rp.replicated_grads, ((2, 2, 1), REP_GRADS, REP_SPECS))], timeout=TIMEOUT)
    return params, whole, one, [o[0] for o in out], tmp, [o[1] for o in out], [o[2] for o in out]


def test_tp_forward_matches_jax_replicated(tp_run):
    params, _, _, out, _, _, _ = tp_run
    x = _batch()["signal"]
    want = np.asarray(_jax_net(16).apply(params, jnp.asarray(x)))
    for o in out:
        np.testing.assert_allclose(o["logits"].numpy(), want, rtol=1e-4, atol=1e-5)


def test_ctc_step_on_data_and_model_matches_jax(tp_run, jax_steps):
    _assert_steps_match(tp_run[3], *jax_steps)


def test_tp_update_clip_reads_the_whole_tree(tp_run):
    """The update clip on a TP mesh takes the norm of the whole tree (a
    max and a sum over "model"), as JAX's global view does: 3 clipped
    steps equal JAX's."""
    _assert_steps_match(tp_run[5], *_jax_steps(CLIP))


# a slice (3, 2) of a (3, 4) leaf split over "model", a replicated (3,) leaf
REP_GRADS = {"w": torch.arange(6.0).reshape(3, 2), "b": torch.tensor([1.0, -2.0, 3.0])}
REP_SPECS = {"w": 1, "b": None}


def test_tp_replicated_gradients_agree(tp_run):
    """all_reduce_grads on (data 2, model 2) when every rank's own sums
    differ: each leaf summed over "data"; a replicated leaf's gradient is
    then the first "model" rank's on every rank, to the bit, and a sharded
    leaf keeps its own slice's."""
    out = tp_run[6]
    ranks = {o["coords"][:2]: r for r, o in enumerate(out)}
    for o in out:
        _, m, _ = o["coords"]
        for name, own in (("w", m), ("b", 0)):
            added = 0.5 * sum(r for (d, mm), r in ranks.items() if mm == own)
            want = 2 * REP_GRADS[name] + added
            assert torch.equal(o["grads"][name], want), (o["coords"], name)


def test_ctc_step_on_data_matches_jax(tp_run, jax_steps):
    out = run_ranks(torch_rank_programs.ctc_train_steps, 2, "gloo", (2, 1, 1), _torch_net(16),
                    tp_run[1], _batch(), STEPS, timeout=TIMEOUT)
    _assert_steps_match(out, *jax_steps)


def test_checkpoint_round_trips_between_one_device_and_tp(tp_run):
    """A single-device checkpoint restores into each TP rank's slices, and
    the TP ranks' checkpoint (gathered, written by rank 0) restores on one
    device as the whole state, bit for bit."""
    _, whole, one, out, tmp, _, _ = tp_run
    specs = param_shardings(_fake_mesh((2, 2, 1), 0), whole, model_parallel=True)
    for rank, o in enumerate(out):
        mesh = _fake_mesh((2, 2, 1), rank)
        got = o["restored"]
        assert int(got["step"]) == 5
        for a, b in zip(tree_leaves(got["params"]),
                        tree_leaves(local_slices(mesh, whole, specs))):
            assert a.shape == b.shape and torch.equal(a, b)
        mu = local_slices(mesh, one.opt_state[0][0]["mu"], specs)
        for name, t in mu.items():
            assert torch.equal(got["opt_state"][0][0]["mu"][name], t), name
        sharded = [n for n, s in specs.items() if s is not None]
        assert got["params"][sharded[0]].shape[-1] * 2 == whole[sharded[0]].shape[-1]
    template = TrainState.create(whole, build_optimizer("adam", 1e-3))
    back = restore_checkpoint(str(tmp / "tp"), template)
    assert int(back.step) == STEPS
    for a, b in zip(tree_leaves(back.params), tree_leaves(out[0]["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(back.opt_state), tree_leaves(out[0]["opt_state"])):
        assert torch.equal(a, b)


def test_dryrun_multichip_on_the_cpu(capsys):
    """The port's __graft_entry__.dryrun_multichip: every check on a (data
    2, model 2, seq 2) mesh of 8 gloo ranks holds to one device."""
    result = graft_entry.dryrun_multichip(8, device="cpu")
    assert result["shape"] == (2, 2, 2)
    assert set(result["errors"]) == {"joint", "raw", "ctc", "step", "decode", "seq_decode"}
    assert "dryrun_multichip ok: mesh=(data=2, model=2, seq=2)" in capsys.readouterr().out

"""The port of ``__graft_entry__.py``: the flagship forward, and the
multi-device dry run that drives every part of the (data, model, seq) path
and holds it to one device.

    fn, args = entry()                       # the flagship RawCTCNet forward
    dryrun_multichip(8)                      # 8 ranks on the card
    dryrun_multichip(8, device="cpu")        # 8 gloo ranks on the CPU

or ``python -m wavenet_speech_tpu_torch.graft_entry [n_ranks] [--device
cpu]``. ``dryrun_multichip(n)`` factors n as JAX does (model 2 and seq 2
where they divide, the rest data), computes the single-device references
on its device, then runs one rank program on n gloo ranks
(``parallel.run_ranks``; on one card they all share it) that takes JAX's
checks in turn:

  1. (seq > 1) the joint WaveNet-CTC loss and every gradient leaf of a
     64-channel model (10 causal blocks d=1..512, a pooled classifier of
     6), L=1024, sequence-sharded by halo exchange, the batch over
     "data", the params TP-sharded over "model" (B4 and B5 at every block,
     B3 for the CTC on the card): rtol 1e-5 (loss), 1e-4 / atol
     1e-6 (gradients). On the card the gradients are held instead to the
     same check in float64 on the CPU (the exact answer, to float32):
     every element within rtol 1e-4 of it plus JOINT_SENS times the
     largest distance of one device's float32 run from it in that leaf.
     The untrained causal stack (the JAX init doubles the residual's
     variance a block) amplifies float32 rounding, so on an H100 the
     mesh's gradients miss JAX's elementwise bound against one device's
     by ~10x with B4/B5 and ~8x with the blocks' plain version on cuBLAS
     float32; the mesh must be no further from the exact answer than a
     few times one device is;
  2. (seq > 1) RawCTCNet (64 features, fk 3, 10 blocks) under SP, its
     L + fk - 1 frames from the featurizer's halo: rtol 1e-5, 1e-4 / 1e-5;
  3. (seq > 1) the sequence-sharded CTC (B3) on (2, 32, 5) logits: the
     loss rtol 1e-6, the gradient 1e-4 / 1e-5;
  4. one Adam step of ``make_ctc_train_step`` on the flagship at 16
     features (B4 and B5 at its 7 centred blocks, B1 and B2), the params
     TP-sharded and the batch over a
     (data x seq, model) mesh of the same ranks (JAX shards the batch over
     "data" and replicates it over "seq"; the port's step would run SP on
     a seq axis > 1): the params within rtol 2e-3 / atol 1e-6 of one
     device's (Adam's division by sqrt(v) amplifies reduction-order noise
     where the gradients are tiny);
  5. ``distributed_beam_decode`` and (seq > 1) ``seq_sharded_beam_decode``
     (B6 on every rank) on biased-blank logits: plens and the live prefix
     entries equal, scores within 1e-5.

Every rank returns its numbers and the kernel launches of each check; a
failed comparison raises. The weights are the port's init from fixed
seeds (the dry run holds the port to itself, as JAX's holds JAX to
itself; the CPU tests hold each piece to JAX).
"""
from __future__ import annotations

import argparse
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (beam_search_kernel,
                                                               ctc_beam_search)
from wavenet_speech_tpu_torch.decoding.distributed import (distributed_beam_decode,
                                                           seq_sharded_beam_decode)
from wavenet_speech_tpu_torch.models import RawCTCNet, WaveNet, WaveNetClassifier
from wavenet_speech_tpu_torch.ops.ctc_scan import ctc_bwd, ctc_fwd
from wavenet_speech_tpu_torch.ops.ctc import ctc_loss_per_seq
from wavenet_speech_tpu_torch.ops.fused_block import fused_gated_block, fused_gated_block_bwd
from wavenet_speech_tpu_torch.parallel.collectives import gather_axis
from wavenet_speech_tpu_torch.parallel.ctc_sharded import ctc_loss_seq_sharded
from wavenet_speech_tpu_torch.parallel.launch import run_ranks
from wavenet_speech_tpu_torch.parallel.mesh import make_mesh
from wavenet_speech_tpu_torch.parallel.sharding import (gather_params, param_shardings,
                                                        shard_batch, shard_params)
from wavenet_speech_tpu_torch.training.loss import JointLoss
from wavenet_speech_tpu_torch.training.optimizer import build_optimizer
from wavenet_speech_tpu_torch.training.trainer import (TrainState, _forward_losses,
                                                       _sharded, all_reduce_grads,
                                                       make_ctc_train_step)
from wavenet_speech_tpu_torch.utils.device import resolve_device
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

MeshShape = Tuple[int, int, int]   # (data, model, seq)
JOINT_D, JOINT_L = 64, 1024
JOINT_SENS = 4.0   # check 1 on the card: the mesh's distance from float64, in one device's
RAW_F, RAW_L = 64, 1024


def _flagship(num_features: int = 256, blocks: int = 5, cycles: int = 2,
              device=None) -> RawCTCNet:
    dils = tuple(2 ** i for i in range(blocks))
    layers = tuple((num_features, num_features, 3, d) for d in dils) * cycles
    return RawCTCNet(num_features, 9, 5, layers, num_features, positions=False,
                     softmax=False, device=device)


def _init(module: torch.nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """The module's weights from the port's init on a seeded generator, as
    a CPU state dict."""
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def entry(device=None):
    """(fn, (params, x)): the flagship RawCTCNet's forward (256 features,
    fk 9, 10 blocks; the port's init from seed 0) on a (2, 1024, 1) zero
    signal, on ``device`` (default cuda)."""
    dev = resolve_device(device)
    net = _flagship(device=dev)
    params = {k: v.to(dev) for k, v in _init(net, 0).items()}

    def fn(params, x):
        return functional_call(net, params, (x,))

    return fn, (params, torch.zeros((2, 1024, 1), device=dev))


def factor(n: int) -> MeshShape:
    """JAX's factoring of n ranks: model 2 and seq 2 where they divide,
    the rest data."""
    model = 2 if n % 2 == 0 else 1
    seq = 2 if n % (model * 2) == 0 else 1
    return n // (model * seq), model, seq


# ---- the models and inputs -------------------------------------------------------

def _joint_models(device):
    D = JOINT_D
    wn = WaveNet(D, 2, tuple((D, D, 2, d) for d in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)),
                 D, softmax=False, device=device)
    clf = WaveNetClassifier(D, 5, tuple((D, D, 2, d) for d in (1, 2, 4, 8, 16, 32)), D,
                            pool_kernel_size=4, softmax=False, device=device)
    return wn, clf


def _raw_model(device):
    F = RAW_F
    return RawCTCNet(F, 3, 5, tuple((F, F, 2, d) for d in (1, 2, 4, 8, 16)) * 2, F,
                     positions=False, softmax=False, device=device)


def inputs(shape: MeshShape) -> Dict[str, Any]:
    """The dry run's weights and global inputs (CPU tensors and numpy), as
    __graft_entry__.py makes them (the weights from the port's init)."""
    data, _, seq = shape
    B, L = data * 2, 64
    rng = np.random.default_rng(0)
    out: Dict[str, Any] = {"batch": {
        "signal": rng.standard_normal((B, L, 1)).astype(np.float32),
        "labels": np.ones((B, 8), np.int32),
        "label_lengths": np.full((B,), 8, np.int32),
        "signal_lengths": np.full((B,), L, np.int32)}}
    out["params"] = _init(_flagship(16, 3, 2), 0)
    if seq > 1:
        wn, clf = _joint_models("cpu")
        out["joint_params"] = {"base": _init(wn, 1), "ctc": _init(clf, 2)}
        D = JOINT_D
        sig = np.eye(D, dtype=np.float32)[
            np.random.default_rng(3).integers(0, D, size=(B, JOINT_L))]
        out["joint_batch"] = {"signal": sig, "labels": out["batch"]["labels"],
                              "label_lengths": out["batch"]["label_lengths"]}
        out["raw_params"] = _init(_raw_model("cpu"), 4)
        out["raw_batch"] = {"signal": np.random.default_rng(5).standard_normal(
            (B, RAW_L, 1)).astype(np.float32), "labels": out["batch"]["labels"],
            "label_lengths": out["batch"]["label_lengths"]}
        rngc = np.random.default_rng(7)
        out["ctc"] = {"logits": rngc.standard_normal((2, 32, 5)).astype(np.float32),
                      "labels": rngc.integers(1, 5, size=(2, 6)).astype(np.int32),
                      "label_lengths": np.array([6, 4], np.int32),
                      "logit_lengths": np.array([32, 23], np.int32)}
    rngd = np.random.default_rng(11)
    Bd, Td = max(2 * data, 2), 64 * seq
    logits = (3.0 * rngd.standard_normal((Bd, Td, 5))).astype(np.float32)
    logits[rngd.random((Bd, Td)) < 0.7, 0] += 6.0
    lens = np.full((Bd,), Td, np.int32)
    lens[1] = Td - Td // 4   # one ragged sequence
    out["decode"] = {"logits": logits, "lengths": lens, "beam_width": 7,
                     "max_label_len": Td // 2}
    return out


# ---- launches --------------------------------------------------------------------

def reset_launches() -> None:
    """Every kernel wrapper's launch count set to 0."""
    for fn in (fused_gated_block, fused_gated_block_bwd):
        fn.launches = fn.launches_bf16 = 0
    fused_gated_block.launches_centred = 0
    for fn in (ctc_fwd, ctc_bwd):
        fn.launches = fn.launches_segment = 0
    beam_search_kernel.launches = 0


def launches() -> Dict[str, int]:
    """The launch counts since ``reset_launches``, by kernel: B4
    fused_gated_block, B5 fused_gated_block_bwd (and their bf16 forms; B4's
    launches of centred blocks, either form, again as
    fused_gated_block_centred), B1 ctc_alpha, B2 ctc_beta, B3
    ctc_alpha_segment and ctc_beta_segment, B6 ctc_beam."""
    return {"fused_gated_block": fused_gated_block.launches,
            "fused_gated_block_bwd": fused_gated_block_bwd.launches,
            "fused_gated_block_bf16": fused_gated_block.launches_bf16,
            "fused_gated_block_bwd_bf16": fused_gated_block_bwd.launches_bf16,
            "fused_gated_block_centred": fused_gated_block.launches_centred,
            "ctc_alpha": ctc_fwd.launches, "ctc_beta": ctc_bwd.launches,
            "ctc_alpha_segment": ctc_fwd.launches_segment,
            "ctc_beta_segment": ctc_bwd.launches_segment,
            "ctc_beam": beam_search_kernel.launches}


def _counted(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    reset_launches()
    out = fn(*args, **kwargs)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return dict(out, launches={k: v for k, v in launches().items() if v})


# ---- the checks: one device, and one rank of the mesh ----------------------------

def _value_and_grads(params, objective):
    """(value, gradient tree) of objective(params) on detached copies."""
    leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    total = objective(tree)
    grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    return total, tree_unflatten(params, list(grads))


def _joint(dev, inp, mesh=None, dtype=torch.float32) -> Dict[str, Any]:
    """Check 1: the joint loss and gradients, params and signal in dtype;
    on a mesh SP + DP + TP."""
    wn, clf = _joint_models(dev)
    params = tree_map(lambda t: t.to(dev, dtype), inp["joint_params"])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in inp["joint_batch"].items()}
    batch["signal"] = batch["signal"].to(dtype)
    if mesh is None:
        loss, grads = _value_and_grads(params, lambda p: _forward_losses(
            wn, clf, JointLoss("joint"), p, batch, None, None)[0])
        return {"loss": float(loss.detach()), "grads": grads}
    specs = param_shardings(mesh, params, model_parallel=True)
    local = shard_params(mesh, params, model_parallel=True)
    batch = shard_batch(mesh, batch, seq_keys=("signal",))
    loss, grads = _value_and_grads(local, lambda p: _forward_losses(
        wn, clf, JointLoss("joint"), gather_params(mesh, p, specs), batch, None, None,
        mesh)[0])
    with torch.no_grad():
        grads = gather_params(mesh, all_reduce_grads(grads, mesh), specs)
    return {"loss": float(loss.detach()), "grads": grads}


def _raw(dev, inp, mesh=None) -> Dict[str, Any]:
    """Check 2: RawCTCNet's CTC loss (a batch sum over T) and gradients;
    on a mesh under SP, the batch over "data"."""
    net = _raw_model(dev)
    params = tree_map(lambda t: t.to(dev), inp["raw_params"])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in inp["raw_batch"].items()}
    if mesh is not None:
        params = shard_params(mesh, params)
        batch = shard_batch(mesh, batch, seq_keys=("signal",))

    def objective(p):
        with _sharded(mesh):
            logits = functional_call(net, p, (batch["signal"],))
        return JointLoss("ctc").calculate(None, None, logits, batch["labels"],
                                          batch["label_lengths"],
                                          **({} if mesh is None else {"mesh": mesh}))[1]

    loss, grads = _value_and_grads(params, objective)
    with torch.no_grad():
        grads = all_reduce_grads(grads, mesh)
    return {"loss": float(loss.detach()), "grads": grads}


def _ctc(dev, inp, mesh=None) -> Dict[str, Any]:
    """Check 3: the summed CTC of fixed logits and its gradient; on a
    mesh sequence-sharded (B3), every row on every rank."""
    c = {k: torch.as_tensor(v).to(dev) for k, v in inp["ctc"].items()}
    x = c["logits"]
    if mesh is not None:
        n, i = mesh.axis_size("seq"), mesh.axis_index("seq")
        Tl = x.shape[1] // n
        x = x[:, i * Tl:(i + 1) * Tl].contiguous()
    x = x.detach().requires_grad_(True)
    if mesh is None:
        losses = ctc_loss_per_seq(x, c["logit_lengths"], c["labels"], c["label_lengths"])
        weight = 1.0
    else:
        losses = ctc_loss_seq_sharded(mesh, x, c["logit_lengths"], c["labels"],
                                      c["label_lengths"])
        weight = 1.0 if mesh.axis_index("seq") == mesh.axis_size("seq") - 1 else 0.0
    grad, = torch.autograd.grad(losses.sum() * weight, x)
    if mesh is not None:
        grad = gather_axis(grad, mesh, "seq", 1)
    return {"loss": float(losses.detach().sum()), "grad": grad}


def _step(dev, inp, mesh=None) -> Dict[str, Any]:
    """Check 4: one Adam step of make_ctc_train_step on the flagship at 16
    features; on a mesh the params TP-sharded, the batch over "data"."""
    net = _flagship(16, 3, 2, device=dev)
    params = tree_map(lambda t: t.to(dev), inp["params"])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in inp["batch"].items()}
    tx = build_optimizer("adam", 1e-3)
    step = make_ctc_train_step(net, tx, mesh=mesh)
    if mesh is not None:
        specs = param_shardings(mesh, params, model_parallel=True)
        params = shard_params(mesh, params, model_parallel=True)
        batch = shard_batch(mesh, batch)
    state, metrics = step(TrainState.create(params, tx), batch)
    out = state.params
    if mesh is not None:
        with torch.no_grad():
            out = gather_params(mesh, out, specs)
    return {"loss": float(metrics["ctc_loss"]), "params": out}


def _decode(dev, inp, mesh=None, seq_sharded: bool = False) -> Dict[str, Any]:
    """Check 5: the beam search (W=7) of biased-blank logits; on a mesh
    batch-sharded, or with seq_sharded time-sharded with the state passed
    along the seq line (rows over "data" too)."""
    d = inp["decode"]
    kw = dict(beam_width=d["beam_width"], max_label_len=d["max_label_len"])
    logits = torch.as_tensor(d["logits"]).to(dev)
    lengths = torch.as_tensor(d["lengths"]).to(dev)
    if mesh is None:
        out = ctc_beam_search(logits, lengths, **kw)
    elif seq_sharded:
        out = seq_sharded_beam_decode(mesh, logits, lengths, data_sharded=True, **kw)[:3]
    else:
        out = distributed_beam_decode(mesh, logits, lengths, **kw)
    return dict(zip(("prefixes", "plens", "scores"), out))


def _checks(shape: MeshShape):
    """(name, function, keyword arguments) of every check of the dry run on
    a mesh of this shape."""
    seq = shape[2]
    out = [("joint", _joint, {}), ("raw", _raw, {}), ("ctc", _ctc, {})] if seq > 1 else []
    out += [("step", _step, {}), ("decode", _decode, {})]
    if seq > 1:
        out.append(("seq_decode", _decode, {"seq_sharded": True}))
    return out


def references(shape: MeshShape, inp: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Every check on one device (default cuda), results on the CPU; on the
    card also check 1 in float64 on the CPU ("joint64")."""
    dev = resolve_device(device)
    refs = {}
    if dev.type == "cuda" and shape[2] > 1:
        refs["joint64"] = _joint(torch.device("cpu"), inp, dtype=torch.float64)
    for name, fn, _ in _checks(shape):
        if name == "seq_decode":   # one device decodes one way
            refs[name] = refs["decode"]
            continue
        refs[name] = tree_map(lambda t: t.cpu() if torch.is_tensor(t) else t,
                              _counted(fn, dev, inp))
    return refs


def dryrun_rank(shape: MeshShape, inp: Dict[str, Any], device=None) -> Dict[str, Any]:
    """One rank of the dry run (module-level: run_ranks spawns it): every
    check on the (data, model, seq) mesh, check 4 on (data x seq, model,
    1), each with its launches. device: this rank's (None: make_mesh's
    cuda default)."""
    data, model, seq = shape
    mesh = make_mesh(data=data, model=model, seq=seq, device=device)
    step_mesh = mesh if seq == 1 else make_mesh(data=data * seq, model=model, seq=1,
                                                device=device)
    out = {"mesh": repr(mesh), "step_mesh": repr(step_mesh)}
    for name, fn, kw in _checks(shape):
        out[name] = _counted(fn, mesh.device, inp, step_mesh if name == "step" else mesh,
                             **kw)
    return out


# ---- the comparisons --------------------------------------------------------------

def _close(name, got, want, rtol, atol) -> float:
    """max |got - want|; raises when an element is beyond atol + rtol
    |want|."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"dryrun_multichip: {name}: max |diff| {float(err.max()):.3e} "
                             f"beyond rtol {rtol}, atol {atol}")
    return float(err.max())


def _max_diff(got, want) -> float:
    return max(float((g.detach().double().cpu() - w.detach().double().cpu()).abs().max())
               for g, w in zip(tree_leaves(got), tree_leaves(want)))


def _close_tree(name, got, want, rtol, atol) -> float:
    errs = [0.0]
    for (k, g), w in zip(_named_leaves(got), tree_leaves(want)):
        errs.append(_close(f"{name} {k}", g, w, rtol, atol))
    return max(errs)


def _close_to_exact(name, got, one, exact, rtol, atol) -> float:
    """Each leaf of got within rtol |exact| + max(atol, JOINT_SENS x max
    |one - exact| over the leaf) of exact, elementwise; raises past it.
    Returns the largest ratio over the leaves of got's distance from exact
    to one's (both the leaf's max)."""
    worst = 0.0
    for (k, g), w, x in zip(_named_leaves(got), tree_leaves(one), tree_leaves(exact)):
        x = x.detach().double().cpu()
        d_one = float((w.detach().double().cpu() - x).abs().max())
        _close(f"{name} {k} from float64", g, x, rtol, max(atol, JOINT_SENS * d_one))
        d_got = float((g.detach().double().cpu() - x).abs().max())
        worst = max(worst, d_got / d_one if d_one else (0.0 if d_got == 0 else math.inf))
    return worst


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def _check_decode(name, got, want) -> float:
    plens, w_plens = got["plens"].cpu(), want["plens"].cpu()
    if not torch.equal(plens, w_plens):
        raise AssertionError(f"dryrun_multichip: {name}: plens differ")
    S = want["prefixes"].shape[-1]
    live = torch.arange(S)[None, None, :] < w_plens[:, :, None]
    if not torch.equal(torch.where(live, got["prefixes"].cpu(), 0),
                       torch.where(live, want["prefixes"].cpu(), 0)):
        raise AssertionError(f"dryrun_multichip: {name}: prefixes differ")
    return _close(f"{name} scores", got["scores"], want["scores"], 1e-5, 1e-5)


def check(refs: Dict[str, Any], ranks, shape: MeshShape,
          kernels: bool = False) -> Dict[str, float]:
    """Every rank's results against the single-device ones at JAX's
    tolerances (the module docstring); raises on the first miss. Returns
    the largest error of each check over the ranks. kernels: the runs
    launched the card's kernels, so the joint check's gradients are held
    to refs["joint64"] (see the module docstring), and "joint_from_f64" is
    the largest ratio of a leaf's distance from it to one device's."""
    errs: Dict[str, float] = {}
    for r, got in enumerate(ranks):
        for name, _, _ in _checks(shape):
            g, w = got[name], refs[name]
            where = f"rank {r} {name}"
            if name == "joint":
                if kernels:
                    ratio = _close_to_exact(f"{where} grad", g["grads"], w["grads"],
                                            refs["joint64"]["grads"], 1e-4, 1e-6)
                    errs["joint_from_f64"] = max(errs.get("joint_from_f64", 0.0), ratio)
                e = max(_close(f"{where} loss", torch.tensor(g["loss"]),
                               torch.tensor(w["loss"]), 1e-5, 0.0),
                        _max_diff(g["grads"], w["grads"]) if kernels else
                        _close_tree(f"{where} grad", g["grads"], w["grads"], 1e-4, 1e-6))
            elif name == "raw":
                e = max(_close(f"{where} loss", torch.tensor(g["loss"]),
                               torch.tensor(w["loss"]), 1e-5, 0.0),
                        _close_tree(f"{where} grad", g["grads"], w["grads"], 1e-4, 1e-5))
            elif name == "ctc":
                e = max(_close(f"{where} loss", torch.tensor(g["loss"]),
                               torch.tensor(w["loss"]), 1e-6, 0.0),
                        _close(f"{where} grad", g["grad"], w["grad"], 1e-4, 1e-5))
            elif name == "step":
                if not np.isfinite(g["loss"]):
                    raise AssertionError(f"dryrun_multichip: {where}: loss {g['loss']}")
                e = _close_tree(f"{where} params", g["params"], w["params"], 2e-3, 1e-6)
            else:
                e = _check_decode(where, g, w)
            errs[name] = max(errs.get(name, 0.0), e)
    return errs


def dryrun_multichip(n_ranks: int = 8, device=None,
                     rank_program: Optional[Callable] = None) -> Dict[str, Any]:
    """The dry run on n_ranks gloo ranks (see the module docstring); device
    None runs the references and every rank on the card (cuda), "cpu" on
    the CPU. rank_program (default ``dryrun_rank``; module-level, same
    arguments) lets a caller wrap the rank's checks. Prints JAX's closing
    line; returns the mesh shape, the references' and every rank's
    launches, the largest error of each check, and every rank's result."""
    shape = factor(n_ranks)
    data, model, seq = shape
    inp = inputs(shape)
    refs = references(shape, inp, device)
    ranks = run_ranks(rank_program or dryrun_rank, n_ranks, "gloo", shape, inp,
                      None if device is None else str(device), timeout=900.0)
    errs = check(refs, ranks, shape, kernels=resolve_device(device).type == "cuda")
    loss = ranks[0]["step"]["loss"]
    print(f"dryrun_multichip ok: mesh=(data={data}, model={model}, seq={seq}) "
          f"ctc_loss={loss:.4f}; SP-in-train-step loss/grad == single-device "
          f"(bench-shaped 64ch/L=1024 joint model, rtol 1e-4); "
          f"RawCTCNet SP (L+fk-1 featurizer halo) loss/grad == single-device; "
          f"post-step params == single-device; "
          f"batch-sharded beam decode == single-device"
          + ("; seq-sharded (ppermute hypothesis exchange) beam decode == "
             "single-device" if seq > 1 else ""), flush=True)
    return {"shape": shape, "errors": errs, "ranks": ranks, "references": refs,
            "reference_launches": {k: v.get("launches", {}) for k, v in refs.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m wavenet_speech_tpu_torch.graft_entry")
    ap.add_argument("n_ranks", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)


if __name__ == "__main__":
    main()

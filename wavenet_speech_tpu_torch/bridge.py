"""JAX param pytree (and train state) -> the port's parameters (and
train state).

The JAX package keeps parameters as nested dicts (wavenet_speech_tpu/
models/*.py ``init``); the port keeps the same layout per tensor (conv
kernels (K, C_in, C_out), dense kernels (C_in, C_out), the fused
``[tanh|sigmoid]`` gate and ``[resid|skip]`` 1x1 halves kept fused), so the
bridge only renames and, for a stack, unstacks.

A SkipSumStack comes in two layouts (wavenet_speech_tpu/models/
stack.py:95-107): unrolled ``blocks/{i}``, or cycle-stacked ``cycle/b{j}``
whose leaves carry a leading repeats axis, layer index = r * c + j. The
facade builds WaveNet cycle-stacked, so a checkpoint of the CLI is in the
second layout; ``bench.py`` builds unrolled.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _stack_layers(p: Tree) -> List[Tree]:
    if "blocks" in p:
        return [p["blocks"][str(i)] for i in range(len(p["blocks"]))]
    cycle = p["cycle"]
    c = len(cycle)
    repeats = np.asarray(cycle["b0"]["bottleneck"]["b"]).shape[0]
    return [_index(cycle[f"b{j}"], r) for r in range(repeats) for j in range(c)]


def _dense(p: Tree, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}w": _t(p["w"]), f"{prefix}b": _t(p["b"])}


def _block(p: Tree, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}gate_w": _t(p["gate"]["w"]),
            f"{prefix}gate_b": _t(p["gate"]["b"]),
            f"{prefix}out_w": _t(p["out1x1"]["w"]),
            f"{prefix}out_b": _t(p["out1x1"]["b"]),
            f"{prefix}res_w": _t(p["residual_proj"]["w"]),
            f"{prefix}res_b": _t(p["residual_proj"]["b"])}


def _stack(p: Tree, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for i, layer in enumerate(_stack_layers(p)):
        out.update(_block(layer["block"], f"{prefix}blocks.{i}."))
        out.update(_dense(layer["bottleneck"], f"{prefix}bottlenecks.{i}."))
    return out


def wavenet_from_jax(p: Tree) -> Dict[str, torch.Tensor]:
    """State dict of ``models.WaveNet`` from JAX ``WaveNet.init`` params."""
    return {**_dense(p["entry"], "entry."), **_stack(p["stack"], "stack."),
            **_dense(p["out1"], "out1."), **_dense(p["out2"], "out2.")}


def classifier_from_jax(p: Tree) -> Dict[str, torch.Tensor]:
    """State dict of ``models.WaveNetClassifier`` from JAX params."""
    return {**_block(p["input_block"], "input_block."),
            **_dense(p["input_bottleneck"], "input_bottleneck."),
            **_stack(p["stack"], "stack."),
            **_dense(p["out1"], "out1."), **_dense(p["out2"], "out2.")}


def param_tree_from_jax(tree: Tree) -> Dict[str, Dict[str, torch.Tensor]]:
    """The train step's params tree {"base": WaveNet state dict, "ctc":
    WaveNetClassifier state dict} from JAX params {"base": ..., "ctc": ...}."""
    return {"base": wavenet_from_jax(tree["base"]),
            "ctc": classifier_from_jax(tree["ctc"])}


def params_from_jax(tree: Tree) -> Dict[str, torch.Tensor]:
    """State dict of ``facade.Model("wavenet-ctc")`` from the JAX facade's
    params {"base": WaveNet params, "ctc": WaveNetClassifier params}."""
    p = param_tree_from_jax(tree)
    return {**{f"model_base.{k}": v for k, v in p["base"].items()},
            **{f"model_ctc.{k}": v for k, v in p["ctc"].items()}}


def _opt_state_from_jax(s):
    """An optax state -> the port's (training/optimizer.py): a chain's tuple
    stays a tuple, a state NamedTuple becomes a dict of its fields, a
    param-shaped tree is bridged like the params, a scalar (a count)
    becomes a tensor."""
    if hasattr(s, "_fields"):
        return {f: _opt_state_from_jax(getattr(s, f)) for f in s._fields}
    if isinstance(s, (tuple, list)):
        return tuple(_opt_state_from_jax(v) for v in s)
    if isinstance(s, dict):
        return param_tree_from_jax(s)
    return torch.from_numpy(np.array(s))


def train_state_from_jax(state):
    """A JAX ``training.TrainState`` (params {"base", "ctc"}, the optax
    state of ``build_optimizer``, step) as the port's ``TrainState``, on the
    CPU: a JAX run resumes in the port. Covers every rule of
    ``build_optimizer``: adagrad's sum_of_squares, adam/adamw/adamax's mu,
    nu and count, rmsprop's nu, a schedule's count."""
    from wavenet_speech_tpu_torch.training.trainer import TrainState

    return TrainState(params=param_tree_from_jax(state.params),
                      opt_state=_opt_state_from_jax(state.opt_state),
                      step=torch.from_numpy(np.array(state.step, dtype=np.int32)))

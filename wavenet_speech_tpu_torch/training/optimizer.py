"""Optimizers (wavenet_speech_tpu/training/optimizer.py), written by hand to
optax 0.2's update rules; ``torch.optim`` differs in all of them.

A rule is a ``GradientTransformation`` (init, update) over trees of tensors
(``utils.tree``), as in optax, and the optimizer state nests as optax's
does: a chain is a tuple of its parts' states, a rule's state a dict of
optax's field names (``{}`` where optax has an empty state). So a JAX
state maps onto the port field by field (``bridge.train_state_from_jax``).

Where optax and ``torch.optim`` part:
  * adagrad: the accumulator starts at 0.1, eps = 1e-7 sits inside the
    rsqrt, and the update is 0 where the accumulator is 0 (torch: 0, 1e-10
    outside the sqrt);
  * rmsprop: decay 0.9, eps = 1e-8 inside the sqrt, nu starts at 0 (torch:
    alpha 0.99, eps outside);
  * adam/adamw: bias-corrected moments, eps outside the sqrt, adamw's decay
    added to the update before the learning rate; adamax: nu =
    max(|g| + eps, b2 * nu), no bias correction of nu.
The updates are negated by the learning rate (``scale_by_learning_rate``)
and added to the params by ``apply_updates``.

Each rule's elementwise arithmetic is one call of ``ops.multi_tensor`` on
the lists of its trees' leaves: on the card one kernel launch over every
leaf (float32; another type raises), elsewhere the per-leaf PyTorch
operators the rules were written in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from wavenet_speech_tpu_torch.ops import multi_tensor
from wavenet_speech_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Schedule = Callable[[torch.Tensor], torch.Tensor]
ScalarOrSchedule = Union[float, Schedule]
_INT32_MAX = 2**31 - 1


class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (updates, state, params=None) -> (updates, state)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < _INT32_MAX, count + 1, count)


def chain(*parts: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(p.init(params) for p in parts)

    def update(updates, state, params=None):
        new_state = []
        for part, s in zip(parts, state):
            updates, s = part.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def identity() -> GradientTransformation:
    return GradientTransformation(lambda params: {},
                                  lambda updates, state, params=None: (updates, state))


def _lists(*trees):
    return [tree_leaves(t) for t in trees]


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """optax.scale_by_rss: g * rsqrt(sum g^2 + eps), 0 where the sum is 0."""
    def init(params):
        return {"sum_of_squares": tree_map(
            lambda p: torch.full_like(p, initial_accumulator_value), params)}

    def update(updates, state, params=None):
        u, ssq = multi_tensor.rss(*_lists(updates, state["sum_of_squares"]), eps)
        return (tree_unflatten(updates, u),
                {"sum_of_squares": tree_unflatten(state["sum_of_squares"], ssq)})

    return GradientTransformation(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_rms (eps inside the sqrt, no bias correction)."""
    def init(params):
        return {"nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        u, nu = multi_tensor.rms(*_lists(updates, state["nu"]), decay, eps)
        return tree_unflatten(updates, u), {"nu": tree_unflatten(state["nu"], nu)}

    return GradientTransformation(init, update)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    # a number as the base: made on the device, where a tensor built from
    # one on the host would be a blocking copy
    return 1 - torch.pow(decay, count.float())


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0, no nesterov)."""
    def init(params):
        return {"count": _count(params), "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        count = _safe_increment(state["count"])
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        u, mu, nu = multi_tensor.adam(*_lists(updates, state["mu"], state["nu"]),
                                      b1, b2, eps, c1, c2)
        return tree_unflatten(updates, u), {"count": count,
                                            "mu": tree_unflatten(state["mu"], mu),
                                            "nu": tree_unflatten(state["nu"], nu)}

    return GradientTransformation(init, update)


def scale_by_adamax(b1: float = 0.9, b2: float = 0.999,
                    eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adamax."""
    def init(params):
        return {"count": _count(params), "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params=None):
        count = _safe_increment(state["count"])
        u, mu, nu = multi_tensor.adamax(*_lists(updates, state["mu"], state["nu"]),
                                        b1, b2, eps, _bias_correction(b1, count))
        return tree_unflatten(updates, u), {"count": count,
                                            "mu": tree_unflatten(state["mu"], mu),
                                            "nu": tree_unflatten(state["nu"], nu)}

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        return tree_unflatten(updates, multi_tensor.add_scaled(
            *_lists(updates, params), weight_decay)), state

    return GradientTransformation(lambda params: {}, update)


def _scaled(tree, s):
    return tree_unflatten(tree, multi_tensor.scale(tree_leaves(tree), s))


def scale_by_learning_rate(learning_rate: ScalarOrSchedule) -> GradientTransformation:
    """Multiply by -learning_rate; a schedule is called with the number of
    updates so far (optax.scale_by_schedule, whose state holds the count)."""
    if not callable(learning_rate):
        return GradientTransformation(
            lambda params: {},
            lambda updates, state, params=None: (_scaled(updates, -learning_rate), state))

    def init(params):
        return {"count": _count(params)}

    def update(updates, state, params=None):
        step_size = -learning_rate(state["count"])
        return (_scaled(updates, step_size),
                {"count": _safe_increment(state["count"])})

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    return tree_unflatten(params, multi_tensor.add(*_lists(params, updates)))


def _polynomial(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule (power 1, transition_begin 0)."""
    if transition_steps <= 0:
        return lambda count: torch.full_like(count, init_value, dtype=torch.float32)

    def schedule(count):
        c = torch.clamp(count, 0, transition_steps).float()
        return (init_value - end_value) * (1 - c / transition_steps) + end_value

    return schedule


def _cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = torch.clamp(count.float(), max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _warmup_cosine(peak: float, warmup_steps: int, decay_steps: int,
                   end_value: float) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, peak, ...)."""
    alpha = 0.0 if peak == 0.0 else end_value / peak
    warm = _polynomial(0.0, peak, warmup_steps)
    cos = _cosine_decay(peak, decay_steps - warmup_steps, alpha)
    return lambda count: torch.where(count < warmup_steps, warm(count),
                                     cos(count - warmup_steps))


def make_lr_schedule(opt_cfg: dict) -> ScalarOrSchedule:
    """The config's optim block -> a learning rate or a schedule
    (optimizer.py:128-151): "schedule" null/"constant", "warmup_cosine"
    (linear warmup, cosine decay to end_factor * peak at decay_steps) or
    "warmup_constant"; "warmup_steps" (default 500), "decay_steps",
    "end_factor" (default 0.05)."""
    lr = opt_cfg["learning_rate"]
    sched = (opt_cfg.get("schedule") or "constant").lower()
    if sched == "constant":
        return lr
    warmup = int(opt_cfg.get("warmup_steps", 500))
    if sched == "warmup_cosine":
        return _warmup_cosine(lr, warmup, int(opt_cfg["decay_steps"]),
                              lr * float(opt_cfg.get("end_factor", 0.05)))
    if sched == "warmup_constant":
        return _polynomial(0.0, lr, warmup)
    raise ValueError(f"unknown lr schedule: {sched}")


def build_optimizer(optim_type: str, learning_rate: ScalarOrSchedule,
                    weight_decay: Optional[float] = None,
                    max_grad_norm: Optional[float] = None,
                    max_update_norm: Optional[float] = None) -> GradientTransformation:
    """The chain of optimizer.py:154-193: [safe grad clip] [weight decay]
    rule [safe update clip]. max_grad_norm clips the raw gradients,
    max_update_norm the rule's update (the scale-correct guard for adaptive
    rules: batch-summed CTC gradients reach norms of 1e13 and more).

    The clips read the norm that ``clip_norm`` sets: the train steps set
    the whole tree's on a TP mesh, whose ranks update their slices of the
    params, as JAX's global view does; the elementwise rules run on the
    slices as they are."""
    optim_type = optim_type.lower()
    if optim_type == "adam":
        tx = chain(scale_by_adam(), scale_by_learning_rate(learning_rate))
    elif optim_type == "adamw":
        tx = chain(scale_by_adam(), add_decayed_weights(weight_decay or 0.0),
                   scale_by_learning_rate(learning_rate))
        weight_decay = None  # already applied
    elif optim_type == "adagrad":
        tx = chain(scale_by_rss(), scale_by_learning_rate(learning_rate))
    elif optim_type == "adamax":
        tx = chain(scale_by_adamax(), scale_by_learning_rate(learning_rate))
    elif optim_type == "rmsprop":
        tx = chain(scale_by_rms(), scale_by_learning_rate(learning_rate), identity())
    elif optim_type == "sgd":
        tx = chain(identity(), scale_by_learning_rate(learning_rate))
    else:
        raise ValueError(f"unknown optimizer type: {optim_type}")

    parts = []
    if max_grad_norm:
        parts.append(_clip_by_global_norm_safe(max_grad_norm))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    parts.append(tx)
    if max_update_norm:
        parts.append(_clip_by_global_norm_safe(max_update_norm))
    return chain(*parts)


_norm = threading.local()


@contextlib.contextmanager
def clip_norm(fn: Callable[[Any], torch.Tensor]):
    """Run the region with the norm clips reading fn(tree) (the train
    steps: ``trainer.global_norm_safe`` of the whole tree on a TP mesh);
    outside, a tree's own ``global_norm_safe``."""
    prev = getattr(_norm, "fn", None)
    _norm.fn = fn
    try:
        yield
    finally:
        _norm.fn = prev


def _clip_by_global_norm_safe(max_norm: float) -> GradientTransformation:
    """Clip to max_norm by an overflow-proof global norm (optimizer.py:
    196-218): the stock clip squares in f32, reads inf on finite gradients
    of |g| ~1e18, and would zero every update. The norm is ``clip_norm``'s."""
    from wavenet_speech_tpu_torch.training.trainer import global_norm_safe

    def update(updates, state, params=None):
        g = (getattr(_norm, "fn", None) or global_norm_safe)(updates)
        scale = torch.clamp(max_norm / torch.clamp(g, min=1e-30), max=1.0)
        return _scaled(updates, scale), state

    return GradientTransformation(lambda params: {}, update)


@dataclasses.dataclass
class Optimizer:
    """Stateful facade of the reference's Optimizer class (step/zero_grad/
    adjust_lr); adjust_lr scales the updates (optimizer.py:221-248)."""

    optim_type: str
    lr: float
    weight_decay: Optional[float] = None
    max_grad_norm: Optional[float] = None

    def __post_init__(self):
        self.tx = build_optimizer(self.optim_type, self.lr, self.weight_decay,
                                  self.max_grad_norm)
        self._lr_scale = 1.0

    def init(self, params):
        return self.tx.init(params)

    def update(self, grads, opt_state, params):
        updates, opt_state = self.tx.update(grads, opt_state, params)
        if self._lr_scale != 1.0:
            updates = _scaled(updates, self._lr_scale)
        return updates, opt_state

    def adjust_lr(self, new_lr: float):
        self._lr_scale = new_lr / self.lr


class ReduceLROnPlateau:
    """Host-side plateau scheduler (mode min, factor, patience), as
    optimizer.py:251-274."""

    def __init__(self, optimizer: Optimizer, factor: float = 0.1,
                 patience: int = 10, min_lr: float = 0.0):
        self.optimizer = optimizer
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad_steps = 0
        self.current_lr = optimizer.lr

    def step(self, metric: float):
        if metric < self.best:
            self.best = metric
            self.bad_steps = 0
            return
        self.bad_steps += 1
        if self.bad_steps > self.patience:
            self.current_lr = max(self.current_lr * self.factor, self.min_lr)
            self.optimizer.adjust_lr(self.current_lr)
            self.bad_steps = 0

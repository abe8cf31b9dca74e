"""The train step's skip guard and optimizer rules over whole lists of
tensors: ``csrc/multi_tensor.cu``, a few launches a stage over every leaf,
where the per-leaf operators took 1-7 launches a leaf.

Each function takes lists of leaves (``utils.tree.tree_leaves`` of a tree,
all of one structure) and returns lists in the same order. On leaves off
the card it runs the plain per-leaf arithmetic, the PyTorch operators the
rules were written in (so the CPU tests hold it against JAX). On CUDA
leaves it launches the kernels or raises: every leaf float32 (``select``
also takes int32: it moves 4-byte words), on one device, and each list
the first list's shapes. A strided leaf is read through a dense copy.
``launches`` counts the kernels launched.

A launch's lists reach the kernel as one table of int64 words (chunk
prefix, element counts, pointers; see the source note) in device memory:
built on the host, staged in pinned memory and copied on the launch's
stream, so the host never waits for the queue. The pinned buffer goes back
to PyTorch's pinned-memory cache, which reuses it only once the copy's
event has passed. The outputs of a list are views into one allocation
(each leaf at a 128-byte boundary): one allocation a list, not one a leaf.
Scalars that live on the device (the guard's ``ok``, a clip's scale, a
schedule's learning rate, a bias correction) are read by the kernels from
device memory; nothing is read back to the host.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from wavenet_speech_tpu_torch.ops import _build

Leaves = Sequence[torch.Tensor]
Scalar = Union[float, torch.Tensor]

CHUNK = 16384   # csrc/multi_tensor.cu kChunk: elements a block
ALIGN = 32      # elements from one output leaf's start to the next's (128 bytes)
_FLOAT = (torch.float32,)
_WORDS = (torch.float32, torch.int32)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# every entry point: table, n leaves, chunks; its scalars; stream
_SIGNATURES = {"wst_mt_select": [_P, _I, _L, _P, _I, _P],
               "wst_mt_scale": [_P, _I, _L, _P, _F, _P],
               "wst_mt_axpy": [_P, _I, _L, _F, _P],
               "wst_mt_add": [_P, _I, _L, _P],
               "wst_mt_rss": [_P, _I, _L, _F, _P],
               "wst_mt_rms": [_P, _I, _L, _F, _F, _F, _P],
               "wst_mt_adam": [_P, _I, _L, _F, _F, _F, _F, _F, _P, _P, _P],
               "wst_mt_adamax": [_P, _I, _L, _F, _F, _F, _F, _P, _P],
               "wst_mt_absmax": [_P, _I, _L, _P, _P, _P],
               "wst_mt_sum_squares": [_P, _I, _L, _P, _P, _P, _P]}

launches = 0


def _on_card(xs: Leaves) -> bool:
    """True where the kernels run: the list's first leaf is on a CUDA device."""
    return len(xs) > 0 and xs[0].is_cuda


def _dense(lists: Sequence[Leaves], allowed, what: str) -> List[List[torch.Tensor]]:
    """lists checked for the kernels (CUDA, one device, a type in allowed,
    the first list's shapes and types) and made dense."""
    ref = lists[0]
    index = ref[0].get_device()
    out = []
    for lst in lists:
        if len(lst) != len(ref):
            raise ValueError(f"{what}: lists of {len(lst)} and {len(ref)} leaves")
        dense = []
        for t, r in zip(lst, ref):
            if (not t.is_cuda or t.get_device() != index or t.dtype not in allowed
                    or t.dtype != r.dtype or t.shape != r.shape):
                raise ValueError(
                    f"{what}: every leaf must be a CUDA tensor on cuda:{index} of type "
                    f"{' or '.join(map(str, allowed))}, shaped as the first list's; got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device} beside {r.dtype} "
                    f"{tuple(r.shape)}")
            dense.append(t.contiguous())
        out.append(dense)
    return out


def _device_scalar(s: torch.Tensor, device, dtype, what: str) -> torch.Tensor:
    if not (s.is_cuda and s.device == device and s.dtype == dtype and s.numel() == 1):
        raise ValueError(f"{what}: a scalar must be one {dtype} element on {device}, got "
                         f"{s.dtype} {tuple(s.shape)} on {s.device}")
    return s


def _pointers(lst: Leaves) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in lst), np.int64, len(lst))


def layout(numel: np.ndarray):
    """(starts, offsets) of a launch over leaves of ``numel`` elements:
    starts[i] the first chunk of leaf i (the table's first N+1 words; an
    empty leaf owns no chunk, starts[N] is the grid), offsets[i] leaf i's
    first element in an output list's allocation (a multiple of ALIGN),
    offsets[N] the allocation's size."""
    starts = np.zeros(len(numel) + 1, np.int64)
    np.cumsum(-(-numel // CHUNK), out=starts[1:])
    offsets = np.zeros(len(numel) + 1, np.int64)
    np.cumsum(-(-numel // ALIGN) * ALIGN, out=offsets[1:])
    return starts, offsets


def _launch(entry: str, lists: Sequence[Leaves], n_out: int, *scalars, allowed=_FLOAT,
            reduce: bool = False):
    """csrc/multi_tensor.cu's ``entry`` over ``lists`` (its inputs), with
    ``n_out`` output lists allocated as the first; scalars: the entry's
    arguments between the table and the stream. Returns the output lists,
    or with ``reduce`` the (N,) per-leaf results."""
    global launches
    lists = _dense(lists, allowed, entry)
    first = lists[0]
    n, dev = len(first), first[0].device
    numel = np.fromiter((t.numel() for t in first), np.int64, n)
    starts, offsets = layout(numel)
    chunks = int(starts[-1])
    outs, out_ptrs = [], []
    for _ in range(n_out):
        flat = torch.empty(int(offsets[-1]), dtype=torch.float32, device=dev)
        views = []
        for t, o in zip(first, offsets.tolist()):
            v = flat.as_strided(t.shape, t.stride(), o)
            views.append(v if t.dtype == torch.float32 else v.view(t.dtype))
        outs.append(views)
        out_ptrs.append(flat.data_ptr() + 4 * offsets[:-1])
    table = np.concatenate([starts, numel, *map(_pointers, lists), *out_ptrs])
    table = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
    if reduce:
        partial = torch.empty(max(chunks, 1), dtype=torch.float32, device=dev)
        result = torch.empty(n, dtype=torch.float32, device=dev)
        scalars = (*scalars, partial.data_ptr(), result.data_ptr())
    lib = _build.library("multi_tensor", _SIGNATURES)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(table.data_ptr(), n, chunks, *scalars,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, entry)
    launches += int(chunks > 0) + int(reduce)   # a reduction's second pass: one block
    return result if reduce else outs


# ---- the guard ------------------------------------------------------------------
# Each function X launches on the card and runs X_ref, its plain version
# (the per-leaf operators), on leaves off it; X_ref runs on any device.

def absmax_ref(xs: Leaves) -> torch.Tensor:
    return torch.stack([x.abs().max() for x in xs])


def absmax(xs: Leaves) -> torch.Tensor:
    """(N,) each leaf's largest |x|; NaN for a leaf holding a NaN (as
    torch.max), so the largest of them is finite iff every element is."""
    if _on_card(xs):
        return _launch("wst_mt_absmax", [xs], 0, reduce=True)
    return absmax_ref(xs)


def sum_squares_ref(xs: Leaves, scale: torch.Tensor) -> torch.Tensor:
    if not xs:
        return torch.zeros(0, dtype=scale.dtype, device=scale.device)
    return torch.stack([torch.sum((x / scale) ** 2) for x in xs])


def sum_squares(xs: Leaves, scale: torch.Tensor) -> torch.Tensor:
    """(N,) each leaf's sum of (x / scale)^2, scale a 0-d tensor."""
    if _on_card(xs):
        s = _device_scalar(scale, xs[0].device, torch.float32, "sum_squares")
        return _launch("wst_mt_sum_squares", [xs], 0, s.data_ptr(), reduce=True)
    return sum_squares_ref(xs, scale)


def total_ref(v: torch.Tensor) -> torch.Tensor:
    return sum(v.unbind(), torch.zeros((), dtype=v.dtype, device=v.device))


def total(v: torch.Tensor) -> torch.Tensor:
    """The sum of a (N,) vector of per-leaf values: one reduction on the
    card, and off it the leaves' values added in order."""
    return v.sum() if v.is_cuda else total_ref(v)


def select_ref(ok: torch.Tensor, xs: Leaves, others: Optional[Leaves] = None):
    if others is None:
        return [torch.where(ok, x, 0.0) for x in xs]
    return [torch.where(ok, x, o) for x, o in zip(xs, others)]


def select(ok: torch.Tensor, xs: Leaves, others: Optional[Leaves] = None) -> List[torch.Tensor]:
    """where(ok, x, other) leaf by leaf, other 0 where others is None; ok a
    0-d bool tensor."""
    if _on_card(xs):
        k = _device_scalar(ok, xs[0].device, torch.bool, "select")
        lists = [xs] if others is None else [xs, others]
        return _launch("wst_mt_select", lists, 1, k.data_ptr(), int(others is not None),
                       allowed=_WORDS)[0]
    return select_ref(ok, xs, others)


# ---- the rules ------------------------------------------------------------------

def scale_ref(xs: Leaves, s: Scalar):
    return [s * x for x in xs]


def scale(xs: Leaves, s: Scalar) -> List[torch.Tensor]:
    """s * x: s a number, or a 0-d float32 tensor (a schedule's learning
    rate, a clip's scale)."""
    if not _on_card(xs):
        return scale_ref(xs, s)
    if torch.is_tensor(s):
        ptr = _device_scalar(s, xs[0].device, torch.float32, "scale")
        return _launch("wst_mt_scale", [xs], 1, ptr.data_ptr(), 0.0)[0]
    return _launch("wst_mt_scale", [xs], 1, None, float(s))[0]


def add_scaled_ref(xs: Leaves, ys: Leaves, a: float):
    return [x + a * y for x, y in zip(xs, ys)]


def add_scaled(xs: Leaves, ys: Leaves, a: float) -> List[torch.Tensor]:
    """x + a * y (add_decayed_weights: g + weight_decay * p)."""
    if _on_card(xs):
        return _launch("wst_mt_axpy", [xs, ys], 1, float(a))[0]
    return add_scaled_ref(xs, ys, a)


def add_ref(ps: Leaves, us: Leaves):
    return [(p + u).to(p.dtype) for p, u in zip(ps, us)]


def add(ps: Leaves, us: Leaves) -> List[torch.Tensor]:
    """p + u in p's type (apply_updates)."""
    if _on_card(ps):
        return _launch("wst_mt_add", [ps, us], 1)[0]
    return add_ref(ps, us)


def rss_ref(gs: Leaves, ss: Leaves, eps: float):
    ssq = [g * g + s for g, s in zip(gs, ss)]
    return [torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * g for g, s in zip(gs, ssq)], ssq


def rss(gs: Leaves, ss: Leaves, eps: float):
    """optax.scale_by_rss: (updates, sums) with s' = g*g + s and
    u = where(s' > 0, rsqrt(s' + eps), 0) * g."""
    if _on_card(gs):
        return tuple(_launch("wst_mt_rss", [gs, ss], 2, float(eps)))
    return rss_ref(gs, ss, eps)


def rms_ref(gs: Leaves, nus: Leaves, decay: float, eps: float):
    nu = [(1 - decay) * (g ** 2) + decay * n for g, n in zip(gs, nus)]
    return [torch.rsqrt(n + eps) * g for g, n in zip(gs, nu)], nu


def rms(gs: Leaves, nus: Leaves, decay: float, eps: float):
    """optax.scale_by_rms: (updates, nu) with nu' = (1-decay) g^2 + decay nu
    and u = rsqrt(nu' + eps) * g."""
    if _on_card(gs):
        return tuple(_launch("wst_mt_rms", [gs, nus], 2, 1 - decay, decay, eps))
    return rms_ref(gs, nus, decay, eps)


def adam_ref(gs: Leaves, mus: Leaves, nus: Leaves, b1: float, b2: float, eps: float,
             c1: torch.Tensor, c2: torch.Tensor):
    mu = [(1 - b1) * g + b1 * m for g, m in zip(gs, mus)]
    nu = [(1 - b2) * (g ** 2) + b2 * n for g, n in zip(gs, nus)]
    return [(m / c1) / (torch.sqrt(n / c2) + eps) for m, n in zip(mu, nu)], mu, nu


def adam(gs: Leaves, mus: Leaves, nus: Leaves, b1: float, b2: float, eps: float,
         c1: torch.Tensor, c2: torch.Tensor):
    """optax.scale_by_adam's moments and update, c1 and c2 the bias
    corrections (0-d tensors): (updates, mu, nu)."""
    if not _on_card(gs):
        return adam_ref(gs, mus, nus, b1, b2, eps, c1, c2)
    dev = gs[0].device
    c1 = _device_scalar(c1, dev, torch.float32, "adam")
    c2 = _device_scalar(c2, dev, torch.float32, "adam")
    return tuple(_launch("wst_mt_adam", [gs, mus, nus], 3, 1 - b1, b1, 1 - b2, b2, eps,
                         c1.data_ptr(), c2.data_ptr()))


def adamax_ref(gs: Leaves, mus: Leaves, nus: Leaves, b1: float, b2: float, eps: float,
               c1: torch.Tensor):
    mu = [(1 - b1) * g + b1 * m for g, m in zip(gs, mus)]
    nu = [torch.maximum(torch.abs(g) + eps, b2 * n) for g, n in zip(gs, nus)]
    return [(m / c1) / n for m, n in zip(mu, nu)], mu, nu


def adamax(gs: Leaves, mus: Leaves, nus: Leaves, b1: float, b2: float, eps: float,
           c1: torch.Tensor):
    """optax.scale_by_adamax's moments and update, c1 the first moment's
    bias correction (a 0-d tensor): (updates, mu, nu)."""
    if not _on_card(gs):
        return adamax_ref(gs, mus, nus, b1, b2, eps, c1)
    c1 = _device_scalar(c1, gs[0].device, torch.float32, "adamax")
    return tuple(_launch("wst_mt_adamax", [gs, mus, nus], 3, 1 - b1, b1, b2, eps,
                         c1.data_ptr()))

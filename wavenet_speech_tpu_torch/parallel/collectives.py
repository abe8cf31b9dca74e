"""The collectives of the multi-device path: the torch counterparts of the
``lax.ppermute``, ``lax.psum`` and ``lax.all_gather`` uses in
wavenet_speech_tpu/parallel/halo.py:49-58, ctc_sharded.py:107-156 and
decoding/distributed.py, and of the collectives XLA inserts for a sharded
param or batch.

In JAX, ``shard_map`` gives every device the same program, and AD
transposes the collectives. Here each rank is its own program, so every
rank issues the same collectives in the same order, forward and backward,
and the autograd Functions below carry the transposes:

  * ``shift``: each rank's tensor moves to its neighbour along an axis
    (``+1``: from rank i to i+1, ``-1``: to i-1); a rank with no source
    gets zeros, as ``ppermute`` gives. Its backward is the reverse shift.
  * ``psum_cotangent``: identity forward; the backward sums the cotangent
    over an axis. It marks a value that every rank of the axis holds a copy
    of, whose cotangent may sit on any of them (JAX's replicated output).
  * ``psum``: a sum over one or more axes whose backward sums the
    cotangent over the same axes (statistics that enter the loss).
  * ``gather_axis`` (``gather_slices`` for many tensors): the slices of a
    line laid end to end. Its backward takes this rank's slice of the
    cotangent, with no sum: its uses are a "model" line, whose ranks all
    run the same forward on the same (data, seq) shard, so their
    cotangents are equal, and the gathers of results that enter no loss.
  * ``broadcast``: one rank's tensor on every rank of its line.

``p2p`` is the one transport of the shifts: ``dist.batch_isend_irecv``
with device tensors, except where the group's backend is gloo and the
tensors lie on a CUDA device. Gloo sends and receives host tensors only,
so there the tensors are staged through host memory. That is what lets
two ranks share one card (NCCL refuses two ranks on one device); the
kernels still run on the card. ``transport`` names the choice. Every other
collective is an all-reduce, which gloo runs on CUDA tensors too; gloo has
no all-gather for them, so a gather is an all-reduce of a zero-filled
whole buffer that holds this rank's slice (exact: every other element
adds a zero).

``batch_stats(mesh)`` marks a region whose batch statistics (``mean_var``:
``facade.BatchNorm1d``, ``ops.norm.batch_standardize``) are taken over
every rank of the "data" and "seq" lines, as JAX's global view of a batch
sharded over them takes them.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from wavenet_speech_tpu_torch.parallel.mesh import Mesh

Axes = Union[None, str, Sequence[str]]
STAT_AXES = ("data", "seq")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
_ALIGN = 128           # float32 elements in 512 bytes


def _staged(group, device: torch.device) -> bool:
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def transport(mesh: Mesh, axis: str = "seq") -> str:
    """How ``p2p`` moves tensors along axis on this mesh."""
    if mesh.group(axis) is None:
        return "none (one rank on the axis)"
    if _staged(mesh.group(axis), mesh.device):
        return "gloo, host-staged P2P"
    return f"{dist.get_backend(mesh.group(axis))}, device P2P"


def p2p(mesh: Mesh, axis: str, sends: Sequence[Tuple[int, torch.Tensor]],
        recvs: Sequence[Tuple[int, Tuple[int, ...], torch.dtype]]) -> List[torch.Tensor]:
    """Send each (peer, tensor) and receive each (peer, shape, dtype) along
    axis, peers given as axis indices; returns the received tensors on the
    mesh's device, in the order of recvs. Blocks until all are done."""
    group, line, dev = mesh.group(axis), mesh.line(axis), mesh.device
    staged = _staged(group, dev)
    where = torch.device("cpu") if staged else dev
    ops, bufs = [], []
    for peer, shape, dtype in recvs:
        buf = torch.empty(shape, dtype=dtype, device=where)
        ops.append(dist.P2POp(dist.irecv, buf, line[peer], group))
        bufs.append(buf)
    for peer, t in sends:
        t = t.detach().contiguous()
        ops.append(dist.P2POp(dist.isend, t.cpu() if staged else t, line[peer], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [b.to(dev) for b in bufs]


def _groups(mesh: Mesh, axes: Axes) -> list:
    """The process groups an all-reduce over axes runs on, one after
    another: none on a one-rank mesh; the world's (None) where the axes
    cover the mesh (axes None, or every axis of size > 1 named); else one
    group a named axis of size > 1."""
    if mesh.size == 1:
        return []
    if axes is None:
        return [None]
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    live = [a for a in axes if mesh.axis_size(a) > 1]
    if math.prod(mesh.axis_size(a) for a in live) == mesh.size:
        return [None]
    return [mesh.group(a) for a in live]


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes = None, op: str = "sum") -> torch.Tensor:
    """x reduced (op "sum", "max" or "min") over the ranks of this rank's
    lines along axes (a name, several names, or None: every rank of the
    mesh), returned on every one of them; every one gets the same bits.
    Not differentiable; x is not changed."""
    out = x.detach().clone()
    for group in _groups(mesh, axes):
        dist.all_reduce(out, op=_OPS[op], group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, mesh: Mesh, axes: Axes) -> torch.Tensor:
    """The sum of x over axes (as ``all_reduce``), differentiable: the
    backward sums the cotangent over the same axes (JAX's transpose of
    ``psum``)."""
    if not _groups(mesh, axes):
        return x
    return _Psum.apply(x, mesh, axes)


class _Gather(torch.autograd.Function):
    """Whole tensors from this rank's slices along an axis: one all-reduce
    of one zero-filled flat buffer; the backward is each cotangent's slice
    of this rank."""

    @staticmethod
    def forward(ctx, mesh, axis, dims, *parts):
        i, n = mesh.axis_index(axis), mesh.axis_size(axis)
        shapes = []
        for p, d in zip(parts, dims):
            s = list(p.shape)
            s[d] *= n
            shapes.append(s)
        sizes = [int(torch.Size(s).numel()) for s in shapes]
        # every tensor at a 512-byte boundary, as the allocator places one:
        # a library may pick its algorithm by alignment
        starts = [0]
        for k in sizes[:-1]:
            starts.append(starts[-1] + -(-k // _ALIGN) * _ALIGN)
        flat = torch.zeros(starts[-1] + sizes[-1], dtype=parts[0].dtype,
                           device=parts[0].device)
        wholes = [flat[a:a + k].view(s) for a, k, s in zip(starts, sizes, shapes)]
        for w, p, d in zip(wholes, parts, dims):
            w.narrow(d, i * p.shape[d], p.shape[d]).copy_(p)
        dist.all_reduce(flat, group=mesh.group(axis))
        ctx.i, ctx.dims, ctx.ks = i, dims, [p.shape[d] for p, d in zip(parts, dims)]
        return tuple(wholes)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *(g.narrow(d, ctx.i * k, k).contiguous()
                                    for g, d, k in zip(gs, ctx.dims, ctx.ks)))


def gather_slices(parts: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh,
                  axis: str) -> Tuple[torch.Tensor, ...]:
    """``gather_axis`` of many tensors of one dtype (each along its own
    dim) in one all-reduce."""
    if mesh.axis_size(axis) == 1:
        return tuple(parts)
    return _Gather.apply(mesh, axis, [d % p.dim() for p, d in zip(parts, dims)], *parts)


def gather_axis(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The x of every rank of this rank's line along axis, laid end to end
    along dim in axis order (JAX's tiled ``all_gather``), on every one of
    them. Differentiable: the backward is this rank's slice of the
    cotangent, with no sum (see the module docstring)."""
    return gather_slices([x], [dim], mesh, axis)[0]


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """The x of the rank at index src of this rank's line along axis, on
    every rank of the line, to the bit (an all-reduce in which every other
    rank adds zeros). Not differentiable."""
    return all_reduce(x if mesh.axis_index(axis) == src else torch.zeros_like(x), mesh, axis)


_stats = threading.local()


def current_batch_stats() -> Optional[Mesh]:
    """The mesh over whose "data" and "seq" lines the current region's
    batch statistics are taken, or None (this rank's batch alone)."""
    return getattr(_stats, "mesh", None)


@contextlib.contextmanager
def batch_stats(mesh: Optional[Mesh]):
    """Run the region with its batch statistics taken over every rank of
    the mesh's "data" and "seq" lines (mesh None: this rank's batch)."""
    prev = current_batch_stats()
    _stats.mesh = mesh
    try:
        yield
    finally:
        _stats.mesh = prev


def mean_var(x: torch.Tensor, dims: Tuple[int, ...]):
    """(mean, biased variance, count) of x over dims, kept as size-1 dims,
    in x's dtype: this rank's batch alone outside ``batch_stats``; inside
    it, every rank of the data and seq lines, through ``psum``, so that
    their gradient is the global one. Two passes (the mean, then the sum of
    squared deviations, as ``jnp.var``), summed in float64: raw signals
    sit far from zero (pico-amps ~85), where a float32 sum's rounding
    moves the mean by ~1e-7 of it, and a network amplifies that shift of
    every normalized input; summed in float64, one rank and several give
    the same statistics to float32's last bit or so."""
    mesh = current_batch_stats()
    n = math.prod(x.shape[d] for d in dims)
    if mesh is not None and _groups(mesh, STAT_AXES):
        n *= mesh.axis_size("data") * mesh.axis_size("seq")
    else:
        mesh = None
    total = lambda t: t if mesh is None else psum(t, mesh, STAT_AXES)
    xd = x.double()
    mean = total(xd.sum(dim=dims, keepdim=True)) / n
    var = total(((xd - mean) ** 2).sum(dim=dims, keepdim=True)) / n
    return mean.to(x.dtype), var.to(x.dtype), n


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, step: int) -> torch.Tensor:
    i, n = mesh.axis_index(axis), mesh.axis_size(axis)
    src, dst = i - step, i + step
    sends = [(dst, x)] if 0 <= dst < n else []
    recvs = [(src, tuple(x.shape), x.dtype)] if 0 <= src < n else []
    got = p2p(mesh, axis, sends, recvs)
    return got[0] if got else torch.zeros_like(x)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, step):
        ctx.mesh, ctx.axis, ctx.step = mesh, axis, step
        return _shift(x, mesh, axis, step)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.step), None, None, None


def shift(x: torch.Tensor, mesh: Mesh, axis: str, step: int) -> torch.Tensor:
    """x moved one rank along axis (step +1: rank i gets rank i-1's x; step
    -1: rank i gets rank i+1's x; zeros where there is none).
    Differentiable: the backward shifts the cotangent back."""
    if step not in (1, -1):
        raise ValueError(f"shift: step must be +1 or -1, got {step}")
    if mesh.axis_size(axis) == 1:
        return torch.zeros_like(x)
    return _Shift.apply(x, mesh, axis, step)


class _PsumCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


def psum_cotangent(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x unchanged; its cotangent is summed over axis in the backward."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PsumCotangent.apply(x, mesh, axis)

"""The collectives of the multi-device path: the torch counterparts of the
``lax.ppermute`` and ``lax.psum`` uses in wavenet_speech_tpu/parallel/
halo.py:49-58 and ctc_sharded.py:107-156.

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

``p2p`` is the one transport: ``dist.batch_isend_irecv`` with device
tensors, except where the group's backend is gloo and the tensors lie on
a CUDA device. Gloo sends and receives host tensors only, so there the
tensors are staged through host memory. That is what lets two ranks share
one card (NCCL refuses two ranks on one device); the kernels still run on
the card. ``transport`` names the choice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from wavenet_speech_tpu_torch.parallel.mesh import Mesh


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


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: Optional[str] = None) -> torch.Tensor:
    """The sum of x over the ranks of this rank's line along axis (every
    rank of the mesh with axis None), returned on every one of them. Not
    differentiable; x is not changed."""
    if axis is None:
        if mesh.size == 1:
            return x.clone()
        group = None
    else:
        group = mesh.group(axis)
        if group is None:
            return x.clone()
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


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
        return all_reduce_sum(g.contiguous(), ctx.mesh, ctx.axis), None, None


def psum_cotangent(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x unchanged; its cotangent is summed over axis in the backward."""
    if mesh.axis_size(axis) == 1:
        return x
    return _PsumCotangent.apply(x, mesh, axis)

"""Distributed beam decoding over a mesh (wavenet_speech_tpu/decoding/
distributed.py): each rank is one program of a ``torch.distributed`` world,
and every rank of the mesh calls a decoder with the same global arguments.

* ``distributed_beam_decode`` shards the batch over "data": each data rank
  decodes its rows (``ctc_beam_search``: the beam kernel B6 on the card,
  its plain version on the CPU), and the results are gathered over "data"
  (``collectives.gather_axis``), so every rank returns the whole batch's.

* ``seq_sharded_beam_decode`` shards time over "seq" and passes the beam
  state along the line: seq rank s receives the raw state (prefixes,
  plens, pb, pnb, times) from rank s-1 (``collectives.p2p``), runs its
  frames from it in one beam call with ``state=`` and ``t0 = s * T_local``,
  and sends the state on; the last rank's state is broadcast over "seq"
  (JAX's psum-select: an all-reduce to which every other rank adds zeros,
  exact) and finalized. Decoding stays sequential in time (the prefix
  search is a left-to-right recurrence); the logits never leave their
  rank. A chained call gives the bits of one call (B6 and its plain
  version both take and return the state), so the result is one device's.
"""
from __future__ import annotations

from typing import Optional

import torch

from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (beam_finalize,
                                                               beam_search_kernel,
                                                               beam_search_ref,
                                                               ctc_beam_search)
from wavenet_speech_tpu_torch.parallel.collectives import broadcast, gather_axis, p2p
from wavenet_speech_tpu_torch.parallel.mesh import Mesh


def _lengths(lengths, B: int, T: int, device) -> torch.Tensor:
    if lengths is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    return torch.as_tensor(lengths, dtype=torch.int32).to(device)


def _rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    n, i = mesh.axis_size("data"), mesh.axis_index("data")
    k = x.shape[0] // n
    return x[i * k:(i + 1) * k]


def _gather_rows(mesh: Mesh, *xs):
    return tuple(gather_axis(x, mesh, "data", 0) for x in xs)


def distributed_beam_decode(mesh: Mesh, logits, lengths=None, beam_width: int = 7,
                            blank: int = 0, max_label_len: Optional[int] = None):
    """(B, T, C) logits (the whole batch, on every rank) -> (prefixes (B,
    W, S), plens (B, W), scores (B, W)), best first, on every rank: each
    data rank decodes its B / data rows on the mesh's device, then the
    rows are gathered over "data". B must be divisible by the data axis."""
    logits = torch.as_tensor(logits).to(mesh.device, torch.float32)
    B, T, _ = logits.shape
    if B % mesh.axis_size("data"):
        raise ValueError(f"batch {B} not divisible by data axis {mesh.axis_size('data')}")
    lengths = _lengths(lengths, B, T, logits.device)
    with torch.no_grad():
        out = ctc_beam_search(_rows(mesh, logits), _rows(mesh, lengths),
                              beam_width=beam_width, blank=blank,
                              max_label_len=max_label_len)
        return _gather_rows(mesh, *out)


def seq_sharded_beam_decode(mesh: Mesh, logits, lengths=None, beam_width: int = 7,
                            blank: int = 0, max_label_len: Optional[int] = None,
                            data_sharded: bool = False, log_input: bool = False):
    """Decode (B, T, C) logits (the whole batch, on every rank) whose time
    axis is split over "seq", passing the beam state along the seq line
    (see the module docstring); with data_sharded the rows are split over
    "data" too, and gathered at the end. T must be divisible by the seq
    axis (pad the logits with frames past ``lengths``: they carry the state
    through unchanged).

    Returns (prefixes (B, W, S), plens (B, W), scores (B, W), times
    (B, W, S)), best first, on every rank."""
    logits = torch.as_tensor(logits).to(mesh.device, torch.float32)
    B, T, _ = logits.shape
    n, s = mesh.axis_size("seq"), mesh.axis_index("seq")
    if T % n:
        raise ValueError(f"time axis {T} not divisible by seq axis {n}")
    if data_sharded and B % mesh.axis_size("data"):
        raise ValueError(f"batch {B} not divisible by data axis")
    lengths = _lengths(lengths, B, T, logits.device)
    S = int(max_label_len) if max_label_len is not None else T
    W, Tl = int(beam_width), T // n
    with torch.no_grad():
        lp = logits if log_input else torch.log_softmax(logits, dim=-1)
        if data_sharded:
            lp, lengths = _rows(mesh, lp), _rows(mesh, lengths)
        Bl = lp.shape[0]
        state = None
        if s > 0:
            shapes = ((Bl, W, S), (Bl, W), (Bl, W), (Bl, W), (Bl, W, S))
            dtypes = (torch.int32, torch.int32, torch.float32, torch.float32, torch.int32)
            state = tuple(p2p(mesh, "seq", [], [(s - 1, sh, dt)
                                                for sh, dt in zip(shapes, dtypes)]))
        search = beam_search_ref if lp.device.type == "cpu" else beam_search_kernel
        state = search(lp[:, s * Tl:(s + 1) * Tl].contiguous(), lengths, beam_width=W,
                       max_label_len=S, blank=blank, state=state, t0=s * Tl)
        if s < n - 1:
            p2p(mesh, "seq", [(s + 1, x) for x in state], [])
        state = tuple(broadcast(x, mesh, "seq", n - 1) for x in state)
        out = beam_finalize(state)
        return _gather_rows(mesh, *out) if data_sharded else out

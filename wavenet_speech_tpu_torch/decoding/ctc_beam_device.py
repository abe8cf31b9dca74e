"""On-device CTC prefix beam search (wavenet_speech_tpu/decoding/
ctc_beam_device.py:56-297), batched, with a hand-written CUDA kernel.

State of a batch of beams, as in the JAX package:

  prefixes (B, W, S) int32 labels (0 past each length), plens (B, W) int32,
  pb / pnb (B, W) f32 log-probability of the prefix ending in blank /
  non-blank, times (B, W, S) int32 frame at which each label was emitted.

A frame builds W "stay" candidates (extend by blank or repeat the last
label) and W*K "extend" candidates (one per beam and candidate label),
merges stay(w) with extend(v, last_w) when v is w's parent (prefix_v +
(last_w,) == prefix_w: the only merge possible while live beams hold
distinct prefixes), and keeps the top W by total probability.

``ctc_beam_search`` launches ``csrc/ctc_beam.cu`` on a CUDA tensor. It
replaces the Pallas kernel ops/pallas/attic/beam.py::_beam_kernel, whose
TPU grid ran the sequences one after another. On an H100 the search is
bound by neither bytes nor operations but by its chain of dependent
frames, so one warp runs a sequence's whole frame loop (all sequences at
once), and keeps the hypotheses as a prefix tree of (parent, label,
emission frame) nodes: a frame's work does not grow with the decoded
length, and the rows are written once, at the end.

Like JAX's ``beam_scan``, ``beam_search_ref`` and ``beam_search_kernel``
take a beam state (default: the empty beam) and the global index ``t0``
of their first frame, and return the state: a decode split into calls
gives what one call gives.

On a CPU tensor it runs the plain version here (``beam_init`` /
``beam_scan`` / ``beam_finalize``), a Python loop over frames. It selects
with indexing where JAX contracts one-hot matrices (a TPU workaround), and
uses stable sorts where JAX uses ``lax.top_k`` / ``jnp.argsort``: the lower
index wins a tie, so a stay candidate beats an extend candidate and the
lower label wins the per-frame top-K prune.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from wavenet_speech_tpu_torch.ops import _build

NEG_INF = -1e30
MAX_BEAM_WIDTH = 32  # the CUDA kernel's MAXW

_P, _I = ctypes.c_void_p, ctypes.c_int
# lp, lengths, the input state (prefixes, plens, pb, pnb, times), pool, the
# output state; B, T, C, W, S, K, blank, t0, cap; stream
_SIGNATURES = {"wst_ctc_beam_f32": [_P] * 13 + [_I] * 9 + [_P],
               "wst_ctc_beam_pool_in_shared": [_I] * 4}

BeamState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor]


def _top_k_stable(x: torch.Tensor, k: int):
    """lax.top_k along the last axis: values descending, the lower index
    first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, N, ...) rows selected by idx (B, M) -> (B, M, ...)."""
    shape = idx.shape + table.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (table.dim() - 2)).expand(shape)
    return table.gather(1, flat)


def _beam_step(state: BeamState, lp: torch.Tensor, t: int, *, blank: int,
               prune: Optional[int] = None) -> BeamState:
    """One frame for a batch of beams (the plain version of the kernel's
    loop body). state as above; lp (B, C) log-probs; t the frame index."""
    prefixes, plens, pb, pnb, times = state
    B, W, S = prefixes.shape
    C = lp.shape[-1]
    dev = lp.device
    neg = torch.tensor(NEG_INF, dtype=lp.dtype, device=dev)
    total = torch.logaddexp(pb, pnb)                                # (B, W)
    alive = total > NEG_INF / 2

    last = torch.where(
        plens > 0,
        prefixes.gather(2, (plens - 1).clamp(min=0).long()[..., None])[..., 0],
        -1)                                                         # (B, W)
    lp_last = torch.where(last >= 0, lp.gather(1, last.clamp(min=0).long()),
                          neg)

    # stay candidates: same prefix, blank-extend + repeat-collapse
    stay_pb = total + lp[:, blank:blank + 1]
    stay_pnb = pnb + lp_last

    # extend candidates, one per (beam, candidate label)
    if prune is not None and prune < C:
        lp_cand, labels = _top_k_stable(lp, prune)                  # (B, K)
    else:
        labels = torch.arange(C, device=dev).expand(B, C)
        lp_cand = lp
    K = labels.shape[1]
    same = labels[:, None, :] == last[:, :, None]                   # (B, W, K)
    ext_pnb = torch.where(same, pb[:, :, None], total[:, :, None]) \
        + lp_cand[:, None, :]
    can_extend = (labels[:, None, :] != blank) & (plens[:, :, None] < S)
    ext_pnb = torch.where(can_extend, ext_pnb, neg)

    # merge: stay(w) absorbs extend(v, last_w) when v is w's parent
    care = torch.arange(S, device=dev) < plens[:, :, None]          # (B, Wv, S)
    eq = ((prefixes[:, :, None, :] == prefixes[:, None, :, :])
          | ~care[:, :, None, :]).all(-1)                           # (B, Wv, Ww)
    is_parent = (eq & (plens[:, None, :] == plens[:, :, None] + 1)
                 & alive[:, None, :])
    # ext(v, last_w): the candidate slot holding label last_w, if any
    ext_at_cw = torch.where(same[:, None, :, :], ext_pnb[:, :, None, :],
                            neg).amax(-1)                           # (B, Wv, Ww)
    contrib = torch.where(is_parent, ext_at_cw, neg)
    contrib_mass = torch.logsumexp(contrib, dim=1)                  # (B, W)
    # the merged prefix keeps the times of the more probable path family
    vstar = contrib.argmax(dim=1)                                   # first max
    pos_last = torch.arange(S, device=dev) == (plens - 1)[:, :, None]
    par_times = torch.where(pos_last, t, _take(times, vstar))
    adopt = contrib_mass > torch.logaddexp(stay_pb, stay_pnb)
    stay_times = torch.where(adopt[:, :, None], par_times, times)
    stay_pnb = torch.logaddexp(stay_pnb, contrib_mass)
    # consumed extends leave the pool
    consumed = (is_parent[:, :, :, None] & same[:, None, :, :]).any(2)
    ext_pnb = torch.where(consumed, neg, ext_pnb)

    # top-W of [stay | extend (v, k) row-major]
    cand = torch.cat([torch.logaddexp(stay_pb, stay_pnb),
                      torch.logaddexp(neg, ext_pnb).reshape(B, W * K)], 1)
    _, sel = _top_k_stable(cand, W)                                 # (B, W)
    is_stay = sel < W
    e = (sel - W).clamp(min=0)
    src = torch.where(is_stay, sel, e // K)                         # source row
    lab = labels.gather(1, e % K)

    src_plen = plens.gather(1, src)
    room = src_plen < S
    ins = torch.arange(S, device=dev) == src_plen[:, :, None]       # (B, W, S)
    ins = ins & ~is_stay[:, :, None]
    new_prefixes = torch.where(ins, lab[:, :, None].to(prefixes.dtype),
                               _take(prefixes, src))
    new_times = torch.where(
        is_stay[:, :, None], _take(stay_times, src),
        torch.where(ins, t, _take(times, src)).to(times.dtype))
    new_plens = torch.where(is_stay | ~room, src_plen, src_plen + 1)
    new_pb = torch.where(is_stay, stay_pb.gather(1, src), neg)
    new_pnb = torch.where(is_stay, stay_pnb.gather(1, src),
                          ext_pnb.reshape(B, W * K).gather(1, e))
    return new_prefixes, new_plens, new_pb, new_pnb, new_times


def beam_init(batch: int, beam_width: int, max_label_len: int,
              device=None) -> BeamState:
    """Initial state: slot 0 = empty prefix with probability 1, the other
    slots dead."""
    B, W, S = batch, beam_width, max_label_len
    pb = torch.full((B, W), NEG_INF, device=device)
    pb[:, 0] = 0.0
    return (torch.zeros((B, W, S), dtype=torch.int32, device=device),
            torch.zeros((B, W), dtype=torch.int32, device=device),
            pb,
            torch.full((B, W), NEG_INF, device=device),
            torch.zeros((B, W, S), dtype=torch.int32, device=device))


def beam_scan(state: BeamState, log_probs: torch.Tensor, lengths: torch.Tensor,
              *, t0: int = 0, blank: int = 0, prune: Optional[int] = None) -> BeamState:
    """Advance the state over log_probs (B, T, C), whose frames have the
    global indices t0 + t (JAX's ``ts``); frames t0 + t >= lengths[b]
    carry sequence b's state through unchanged."""
    for t in range(log_probs.shape[1]):
        new = _beam_step(state, log_probs[:, t], t0 + t, blank=blank, prune=prune)
        live = t0 + t < lengths
        state = tuple(
            torch.where(live.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, state))
    return state


def beam_finalize(state: BeamState):
    """Sort each beam best-first (stable) -> (prefixes, plens, scores,
    times)."""
    prefixes, plens, pb, pnb, times = state
    scores = torch.logaddexp(pb, pnb)
    order = torch.argsort(-scores, dim=1, stable=True)
    return (_take(prefixes, order), plens.gather(1, order),
            scores.gather(1, order), _take(times, order))


def _check_state(state: BeamState, B: int, W: int, S: int, device) -> None:
    shapes = [(B, W, S), (B, W), (B, W), (B, W), (B, W, S)]
    dtypes = [torch.int32, torch.int32, torch.float32, torch.float32, torch.int32]
    for x, shape, dtype in zip(state, shapes, dtypes):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != device:
            raise ValueError(f"beam state: expected {shape} {dtype} on {device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")


def beam_search_ref(log_probs: torch.Tensor, lengths: torch.Tensor, *,
                    beam_width: int, max_label_len: int, blank: int = 0,
                    prune: Optional[int] = None, state: Optional[BeamState] = None,
                    t0: int = 0) -> BeamState:
    """The plain version of the kernel: the raw (unsorted) beam state after
    the frames of log_probs, from ``state`` (default: the empty beam), the
    first frame's global index being t0."""
    B = log_probs.shape[0]
    if state is None:
        state = beam_init(B, beam_width, max_label_len, device=log_probs.device)
    else:
        _check_state(state, B, beam_width, max_label_len, log_probs.device)
    return beam_scan(state, log_probs, lengths, t0=t0, blank=blank, prune=prune)


def beam_search_kernel(log_probs: torch.Tensor, lengths: torch.Tensor, *,
                       beam_width: int, max_label_len: int, blank: int = 0,
                       prune: Optional[int] = None, state: Optional[BeamState] = None,
                       t0: int = 0) -> BeamState:
    """The CUDA kernel: one warp runs a sequence's frames. Same arguments
    and result as ``beam_search_ref``; CUDA tensors only. Given a state, it
    reads its plens once on the host, to size the node pool.
    ``beam_search_kernel.launches`` counts launches."""
    if log_probs.device.type != "cuda":
        raise ValueError(f"beam_search_kernel: needs a CUDA tensor, got "
                         f"{log_probs.device}")
    if log_probs.dtype != torch.float32 or log_probs.dim() != 3:
        raise ValueError("beam_search_kernel: log_probs must be (B, T, C) "
                         f"float32, got {tuple(log_probs.shape)} {log_probs.dtype}")
    B, T, C = log_probs.shape
    W, S = int(beam_width), int(max_label_len)
    K = int(prune) if prune is not None and prune < C else C
    if not 1 <= W <= MAX_BEAM_WIDTH:
        raise ValueError(f"beam_search_kernel: beam_width must be in "
                         f"[1, {MAX_BEAM_WIDTH}], got {W}")
    if S < 1 or K < 1 or not 0 <= blank < C or t0 < 0:
        raise ValueError(f"beam_search_kernel: bad max_label_len={S}, "
                         f"prune={prune}, blank={blank} or t0={t0} for C={C}")
    if lengths.shape != (B,):
        raise ValueError(f"beam_search_kernel: lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    dev = log_probs.device
    lp = log_probs.contiguous()
    lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
    i32 = dict(device=dev, dtype=torch.int32)
    # the node pool: the root, the input state's trie (at most one node a
    # label), at most W nodes a frame
    if state is None:
        state_in, n_in = (None,) * 5, 1
    else:
        _check_state(state, B, W, S, dev)
        state_in = tuple(x.contiguous() for x in state)
        n_in = 1 + (int(state_in[1].clamp(0, S).sum(1).max()) if B else 0)
    cap = n_in + W * T
    if cap >= 2 ** 31:
        raise ValueError(f"beam_search_kernel: {cap} pool nodes exceed int32")
    prefixes = torch.empty((B, W, S), **i32)
    times = torch.empty((B, W, S), **i32)
    plens = torch.empty((B, W), **i32)
    pb = torch.empty((B, W), device=dev, dtype=torch.float32)
    pnb = torch.empty_like(pb)
    lib = _build.library("ctc_beam", _SIGNATURES)
    with torch.cuda.device(dev):
        # the pool lives in shared memory where it fits, else in this scratch
        pool = (None if lib.wst_ctc_beam_pool_in_shared(C, W, K, cap)
                else torch.empty((B, 3, cap), **i32))
        ptr = lambda x: None if x is None else x.data_ptr()
        rc = lib.wst_ctc_beam_f32(
            lp.data_ptr(), lens.data_ptr(), *map(ptr, state_in), ptr(pool),
            prefixes.data_ptr(), plens.data_ptr(), pb.data_ptr(), pnb.data_ptr(),
            times.data_ptr(), B, T, C, W, S, K, blank, int(t0), cap,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "beam_search_kernel")
    beam_search_kernel.launches += 1
    return prefixes, plens, pb, pnb, times


beam_search_kernel.launches = 0


def ctc_beam_search(logits: torch.Tensor, lengths=None, beam_width: int = 7,
                    blank: int = 0, max_label_len: Optional[int] = None,
                    log_input: bool = False, return_times: bool = False,
                    prune: Optional[int] = None):
    """Batched CTC prefix beam search (``ctc_beam_search_jax``).

    logits (B, T, C) (log-softmaxed here unless log_input); lengths (B,)
    valid frames (default T); max_label_len caps the decoded length
    (default T); prune keeps the frame's top-K labels as extension
    candidates. On a CUDA tensor this launches the kernel; on a CPU tensor
    it runs the plain version.

    Returns prefixes (B, W, S), plens (B, W), scores (B, W) best-first,
    and times (B, W, S) if return_times."""
    logits = logits.float()
    B, T, C = logits.shape
    lp = logits if log_input else torch.log_softmax(logits, dim=-1)
    lengths = (torch.full((B,), T, dtype=torch.int32, device=lp.device)
               if lengths is None else
               torch.as_tensor(lengths, dtype=torch.int32).to(lp.device))
    S = int(max_label_len) if max_label_len is not None else T
    search = beam_search_ref if lp.device.type == "cpu" else beam_search_kernel
    state = search(lp, lengths, beam_width=beam_width, max_label_len=S,
                   blank=blank, prune=prune)
    prefixes, plens, scores, times = beam_finalize(state)
    if return_times:
        return prefixes, plens, scores, times
    return prefixes, plens, scores

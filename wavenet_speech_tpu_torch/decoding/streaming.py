"""Streaming bounded-memory CTC prefix beam search for long reads
(wavenet_speech_tpu/decoding/streaming.py:74-272).

A monolithic beam over a read of T frames carries (W, T) prefix rows. Here
the beam state has a fixed label window S instead, and is carried from one
chunk of frames to the next:

  feed(chunk) - one call of the beam over the chunk, from the carried state
                (``beam_search_kernel`` on a CUDA tensor, one launch;
                ``beam_search_ref`` on a CPU tensor), the chunk's first frame
                at its global index;
  commit      - the longest common prefix of the live beams is final
                (candidates only extend prefixes), so it moves to the host
                and the window shifts left by its length. At least one label
                stays in every live beam: a beam shifted to an empty window
                would lose its last label, which the repeat rule reads;
  finalize    - the best beam: the committed labels, then its window.

The commit runs with tensor operations on the state's device and gives the
JAX package's bits (its ``np.roll``: the committed labels move to the end
of each row, past ``plens``, where nothing reads them); one small copy a
chunk brings the committed labels and times to the host.

While the window never fills, the decode equals the monolithic beam over
the whole read. When it fills, extensions are masked and the decode is
length-capped: ``saturated_chunks`` counts it and ``StreamingBeam.finalize``
warns.
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from wavenet_speech_tpu_torch.decoding.ctc_beam_device import (NEG_INF, beam_finalize,
                                                               beam_init, beam_search_kernel,
                                                               beam_search_ref)
from wavenet_speech_tpu_torch.utils.device import resolve_device

Decoded = Tuple[np.ndarray, float, np.ndarray]  # labels, score, emission frames


def commit(state, window: int):
    """The commit of every sequence of a batched beam state (B, W, window):
    returns (state shifted, k (B,) labels committed, the committed labels
    and times (B, max k) of each sequence's first live row, saturated (B,)).
    k, the labels, times and saturated are numpy, read in one copy."""
    prefixes, plens, pb, pnb, times = state
    B, W, S = prefixes.shape
    dev = prefixes.device
    alive = torch.logaddexp(pb, pnb) > NEG_INF / 2                      # (B, W)
    big = torch.iinfo(torch.int32).max
    k_max = (torch.where(alive, plens, big).amin(1) - 1).clamp(min=0)
    k_max = torch.where(alive.any(1), k_max, 0)
    first = alive.to(torch.int32).argmax(1)                             # first live row
    take = lambda x: x.gather(1, first[:, None, None].expand(B, 1, S))[:, 0]
    ref_p, ref_t = take(prefixes), take(times)                          # (B, S)
    pos = torch.arange(S, device=dev)
    # the first position where a live row leaves the first live row, or k_max
    stop = ((prefixes != ref_p[:, None]) & alive[..., None]).any(1) | (pos >= k_max[:, None])
    k = stop.to(torch.int32).argmax(1).to(torch.int32)
    idx = ((pos[None] + k[:, None]) % S)[:, None].expand(B, W, S)
    new_plens = plens - k[:, None]
    live_max = torch.where(alive, new_plens, -big).amax(1)
    saturated = alive.any(1) & (live_max >= window)
    flat = torch.cat([k, saturated.to(torch.int32), ref_p.reshape(-1),
                      ref_t.reshape(-1)]).cpu().numpy()
    k_host = flat[:B]
    n = int(k_host.max()) if B else 0
    rows = flat[2 * B:].reshape(2, B, S)[:, :, :n]
    new_state = (prefixes.gather(2, idx), new_plens, pb, pnb, times.gather(2, idx))
    return new_state, k_host, rows[0], rows[1], flat[B:2 * B].astype(bool)


def _joined(parts: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(parts).astype(np.int32) if parts else np.zeros(0, np.int32)


class StreamingBeamBatch:
    """Decode a batch of long sequences together: one beam call a chunk for
    the whole batch, each sequence committing on its own. Every sequence
    shares the chunk grid; frames at or past a sequence's length carry its
    state through, so ragged sequences stop early.

    ``saturated_chunks`` counts (chunk, sequence) pairs whose window was
    full after the commit. The state lives on ``device`` (``cuda`` unless
    given; with no CUDA device and none given this raises)."""

    def __init__(self, batch: int, lengths, beam_width: int = 7, label_window: int = 2048,
                 blank: int = 0, cutoff_top_n: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.batch = int(batch)
        self.lengths = torch.as_tensor(np.asarray(lengths, np.int32), device=self.device)
        if tuple(self.lengths.shape) != (self.batch,):
            raise ValueError(f"lengths must be ({self.batch},), got {tuple(self.lengths.shape)}")
        self.beam_width, self.window, self.blank = int(beam_width), int(label_window), int(blank)
        self.cutoff_top_n = cutoff_top_n
        self.state = beam_init(self.batch, self.beam_width, self.window, device=self.device)
        self._labels: List[List[np.ndarray]] = [[] for _ in range(self.batch)]
        self._times: List[List[np.ndarray]] = [[] for _ in range(self.batch)]
        self.frames_fed = 0
        self.saturated_chunks = 0

    @property
    def committed(self) -> List[np.ndarray]:
        """Each sequence's committed labels."""
        return [_joined(x) for x in self._labels]

    @property
    def committed_times(self) -> List[np.ndarray]:
        """Each sequence's committed labels' emission frames."""
        return [_joined(x) for x in self._times]

    def _advance(self, log_probs: torch.Tensor, lengths: torch.Tensor) -> np.ndarray:
        """One beam call over (B, T_c, C) log-probs from the carried state,
        then the commit; returns which sequences saturated."""
        search = beam_search_ref if self.device.type == "cpu" else beam_search_kernel
        state = search(log_probs, lengths, beam_width=self.beam_width,
                       max_label_len=self.window, blank=self.blank,
                       prune=self.cutoff_top_n, state=self.state, t0=self.frames_fed)
        self.state, k, labels, times, saturated = commit(state, self.window)
        for b in range(self.batch):
            if k[b]:
                self._labels[b].append(labels[b, :k[b]])
                self._times[b].append(times[b, :k[b]])
        return saturated

    def _log_probs(self, log_probs) -> torch.Tensor:
        if not torch.is_tensor(log_probs):
            log_probs = torch.from_numpy(np.array(log_probs, dtype=np.float32))
        return log_probs.to(self.device, torch.float32).contiguous()

    def feed(self, log_probs) -> None:
        """log_probs: (B, T_c, C) log-softmax frames of the next chunk (the
        same grid for all sequences), a tensor or array."""
        lp = self._log_probs(log_probs)
        if lp.shape[0] != self.batch:
            raise ValueError(f"feed: batch {lp.shape[0]} != {self.batch}")
        saturated = self._advance(lp, self.lengths)
        self.frames_fed += lp.shape[1]
        self.saturated_chunks += int(saturated.sum())

    def finalize(self) -> List[Decoded]:
        """(labels, score, times) of each sequence's best hypothesis: its
        committed labels, then the best beam's window."""
        prefixes, plens, scores, times = (x.cpu().numpy() for x in beam_finalize(self.state))
        out = []
        for b in range(self.batch):
            n = int(plens[b, 0])
            out.append((_joined(self._labels[b] + [prefixes[b, 0, :n]]), float(scores[b, 0]),
                        _joined(self._times[b] + [times[b, 0, :n]])))
        return out


class StreamingBeam(StreamingBeamBatch):
    """The streaming decoder of ONE sequence, fed (T_c, C) chunks. Its
    ``state`` is the batched state of one sequence, (1, W, window);
    ``saturated_chunks`` counts the chunks whose window was full after the
    commit."""

    def __init__(self, beam_width: int = 7, label_window: int = 2048, blank: int = 0,
                 cutoff_top_n: Optional[int] = None, device=None):
        super().__init__(1, [0], beam_width, label_window, blank, cutoff_top_n, device)

    @property
    def committed(self) -> np.ndarray:
        return super().committed[0]

    @property
    def committed_times(self) -> np.ndarray:
        return super().committed_times[0]

    def feed(self, log_probs, valid: Optional[int] = None) -> None:
        """Advance over one chunk of (T_c, C) log-softmax frames; rows past
        ``valid`` (default all) are padding and carry the state through, so
        one chunk shape serves any read length."""
        lp = self._log_probs(log_probs)[None]
        valid = lp.shape[1] if valid is None else int(valid)
        lengths = torch.full((1,), self.frames_fed + valid, dtype=torch.int32,
                             device=self.device)
        saturated = self._advance(lp, lengths)
        self.frames_fed += valid
        self.saturated_chunks += int(saturated.any())

    def finalize(self) -> Decoded:
        if self.saturated_chunks:
            warnings.warn(
                f"streaming beam label window ({self.window}) saturated in "
                f"{self.saturated_chunks} chunk(s): extensions were masked and the "
                "decode is length-capped, not monolithic-equal; raise label_window "
                "or feed shorter chunks")
        return super().finalize()[0]


def streaming_beam_decode(log_probs, beam_width: int = 7, label_window: int = 2048,
                          chunk_frames: int = 4096, blank: int = 0, log_input: bool = True,
                          cutoff_top_n: Optional[int] = None, device=None) -> Decoded:
    """Decode ONE (T, C) sequence with the streaming beam in chunks of
    ``chunk_frames`` (the last one padded with carry-through frames, so
    every call has one shape). log_input=False log-softmaxes the input
    first. Runs on the tensor's device, or on ``device`` (``cuda`` unless
    given) for an array. Returns (labels, score, times) of the best
    hypothesis."""
    if device is None and torch.is_tensor(log_probs):
        device = log_probs.device
    sb = StreamingBeam(beam_width, label_window, blank, cutoff_top_n, device)
    lp = sb._log_probs(log_probs)
    if not log_input:
        lp = torch.log_softmax(lp, dim=-1)
    T, C = lp.shape
    for s in range(0, T, chunk_frames):
        chunk = lp[s: s + chunk_frames]
        n = chunk.shape[0]
        if n < chunk_frames:
            chunk = torch.cat([chunk, chunk.new_zeros((chunk_frames - n, C))])
        sb.feed(chunk, valid=n)
    return sb.finalize()

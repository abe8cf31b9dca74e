"""Basecalling: signal in, called sequences out
(wavenet_speech_tpu/inference.py).

    model = Model("raw-ctcnet", cfg).init(0)
    caller = Basecaller(model, beam_width=7, logit_length_fn=model.output_length)
    seqs, scores = caller(signal_batch)            # (B, L, C) -> strings
    seqs, scores = caller.basecall_long_batch(long_reads)  # chunked + streamed

The forward and the beam search run on the caller's device (``cuda``
unless given): on the card causal blocks run the fused-block kernel and the
beam runs the beam kernel. Strings are rendered on the host.

Long reads (10^5-10^6 samples) go through ``chunked_logits*``: overlapping
chunks of ``chunk_len`` samples, each chunk's ``margin`` edge frames
trimmed at interior boundaries, so the kept slices tile the monolithic
forward's logits. The grid counts samples, so it needs a model whose
frames follow its samples one to one (``output_length(L) = L + extra``):
RawCTCNet, a causal WaveNet, a wavenet-ctc pair without pooling. A pooled
head emits L // pool frames, the transformer about L / 3 (a stem of
stride 6, upsampled 2x), and each is refused before any forward (the JAX
package fails its stitching check there, inference.py:252). The margin is
read from the model (``_default_margin``): hand ``Basecaller`` a model that
carries its ``layers`` and ``output_length``, as ``facade.Model`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from wavenet_speech_tpu_torch.decoding.ctc_beam_device import ctc_beam_search
from wavenet_speech_tpu_torch.decoding.greedy import (argmax_decode,
                                                      ctc_collapse,
                                                      labels2strings)
from wavenet_speech_tpu_torch.decoding.streaming import (StreamingBeamBatch,
                                                         streaming_beam_decode)
from wavenet_speech_tpu_torch.training.checkpoint import restore_params
from wavenet_speech_tpu_torch.utils.device import resolve_device
from wavenet_speech_tpu_torch.utils.profiling import span


# The staging copy's piece: the host fills the next piece while the last
# one's DMA runs.
STAGE_PIECE_BYTES = 8 << 20


def _params_of(model):
    if hasattr(model, "params"):
        return model.params()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@dataclasses.dataclass
class Basecaller:
    """End-to-end basecalling pipeline around ``model``, a callable
    (B, L, C) signal -> (B, T, labels) logits such as ``facade.Model``.
    It serves one call at a time: the calls share its staging buffer."""

    model: Callable[[torch.Tensor], torch.Tensor]
    beam_width: int = 7                 # 0 -> greedy
    blank: int = 0
    max_label_len: Optional[int] = None
    cutoff_top_n: Optional[int] = None  # per-frame top-K label pre-prune
    pad_to_multiple: int = 128          # lengths bucketed as in the JAX package
    logit_length_fn: Optional[Callable] = None  # input lens -> logit lens
    device: Optional[torch.device] = None       # default: cuda, or raise
    saturated_chunks: int = dataclasses.field(default=0, init=False)  # last long batch's
    staged_calls: int = dataclasses.field(default=0, init=False)    # calls through the staging
    staging_allocs: int = dataclasses.field(default=0, init=False)  # its (re)allocations

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._stage = None          # flat float32 staging buffer, pinned on a card
        self._stage_read = None     # event of the last DMA out of it
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)

    @classmethod
    def from_checkpoint(cls, model, ckpt_path: str, params_like=None, **kw) -> "Basecaller":
        """A Basecaller around ``model`` with the params file at ckpt_path
        (``Model.save`` / ``training.checkpoint.save_params``) loaded into
        it, checked against params_like (default: the model's own params
        tree)."""
        caller = cls(model=model, **kw)
        params = restore_params(ckpt_path, _params_of(model) if params_like is None
                                else params_like)
        if hasattr(model, "load_params"):
            model.load_params(params)
        else:
            model.load_state_dict(params)
        return caller

    def _stage_to_device(self, raw: np.ndarray, Lp: int) -> torch.Tensor:
        """raw (B, L, C) float32 -> (B, Lp, C) on the device: raw's values,
        then zeros in [L, Lp). The rows go through the Basecaller's staging
        buffer, which is reused across calls and grown when a call needs
        more (``staging_allocs`` counts that): a piece of rows is copied in
        (torch's parallel copy), its bucket tail zeroed (a longer earlier
        call left data there), and its copy to the device queued. On a card
        the buffer is pinned and the copies run on a copy stream, so the
        DMA of one piece overlaps the host's copy of the next; the current
        stream waits for them, and the next call waits for the last of
        them before it writes the buffer."""
        B, L, C = raw.shape
        cuda = self._copy_stream is not None
        if self._stage_read is not None:
            self._stage_read.synchronize()
        n = B * Lp * C
        if self._stage is None or self._stage.numel() < n:
            self._stage = torch.empty(n, dtype=torch.float32, pin_memory=cuda)
            self.staging_allocs += 1
        self.staged_calls += 1
        stage = self._stage[:n].view(B, Lp, C)
        src = torch.from_numpy(raw)
        x = torch.empty((B, Lp, C), dtype=torch.float32, device=self.device)
        rows = max(1, STAGE_PIECE_BYTES // (Lp * C * 4))
        if cuda:
            self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._copy_stream):   # a no-op without one
            for r in range(0, B, rows):
                piece = slice(r, r + rows)
                stage[piece, :L].copy_(src[piece])
                stage[piece, L:].zero_()
                x[piece].copy_(stage[piece], non_blocking=cuda)
        if cuda:
            self._stage_read = self._copy_stream.record_event()
            torch.cuda.current_stream(self.device).wait_event(self._stage_read)
        return x

    def __call__(self, signal, lengths=None) -> Tuple[List[str], List[float]]:
        """signal (B, L, C) -> (sequences, scores). lengths: optional (B,)
        true signal lengths, default L; frames past them (and the bucket
        padding) are not decoded.

        The signal reaches the device through a staging buffer the
        Basecaller keeps (``_stage_to_device``): pinned and copied
        asynchronously on a card, zero-padded to the bucket of
        ``pad_to_multiple`` samples. ``staged_calls`` counts the calls
        through it, ``staging_allocs`` its (re)allocations. The logit
        lengths go to the device without a wait too, so the beam is queued
        behind the forward.

        Under an active ``torch.profiler`` the call marks its phases with
        ``utils.profiling.span``, in order: ``basecall.bucket`` (the bucket
        and the lengths), ``basecall.to_device`` (the copies into the
        staging buffer and the queued copies to the device),
        ``basecall.forward``, ``basecall.decode`` (the beam or the argmax)
        and ``basecall.strings`` (the readbacks and the strings)."""
        with span("basecall.bucket"):
            raw = np.ascontiguousarray(signal, np.float32)
            Lp = -(-raw.shape[1] // self.pad_to_multiple) * self.pad_to_multiple
            if lengths is None:
                lengths = np.full((raw.shape[0],), raw.shape[1], np.int32)
            lengths = np.asarray(lengths, np.int32)
            logit_lens = (np.asarray(self.logit_length_fn(lengths), np.int32)
                          if self.logit_length_fn is not None else lengths)
        with torch.inference_mode():
            with span("basecall.to_device"):
                x_dev = self._stage_to_device(raw, Lp)
            with span("basecall.forward"):
                logits = self.model(x_dev)
            if self.beam_width <= 0:
                with span("basecall.decode"):
                    labels = argmax_decode(logits)
                with span("basecall.strings"):
                    labels = labels.cpu().numpy()
                    return labels2strings(ctc_collapse(labels, lengths=logit_lens,
                                                       blank=self.blank)), \
                        [0.0] * labels.shape[0]
            with span("basecall.decode"):
                lens = torch.from_numpy(logit_lens)
                if self._copy_stream is not None:
                    lens = lens.pin_memory()
                prefixes, plens, scores = ctc_beam_search(
                    logits, lengths=lens.to(self.device, non_blocking=True),
                    beam_width=self.beam_width, blank=self.blank,
                    max_label_len=self.max_label_len or Lp,
                    prune=self.cutoff_top_n)
        with span("basecall.strings"):
            best = prefixes[:, 0].cpu().numpy()
            n = plens[:, 0].cpu().numpy()
            seqs = labels2strings([best[b, : n[b]] for b in range(len(n))])
            return seqs, [float(s) for s in scores[:, 0].cpu()]

    def basecall_long(self, signal, chunk_len: int = 16384, margin: Optional[int] = None,
                      chunk_batch: int = 8, beam_chunk_frames: int = 4096,
                      label_window: int = 2048) -> Tuple[str, float]:
        """Basecall ONE read of any length (L, C) through overlapping chunks
        (``chunked_logits``). Up to max(2 beam_chunk_frames, 8192) logit
        frames one monolithic beam decodes them (``max_label_len`` then caps
        the whole decode); longer reads stream through the bounded-window
        beam (``decoding.streaming``), whose state is carried from one chunk
        of ``beam_chunk_frames`` to the next."""
        with torch.inference_mode():
            logits = chunked_logits(self.model, torch.as_tensor(
                np.asarray(signal, np.float32)).to(self.device), chunk_len, margin,
                chunk_batch)
            T = logits.shape[0]
            if self.beam_width <= 0:
                labels = argmax_decode(logits).cpu().numpy()[None]
                return labels2strings(ctc_collapse(labels, blank=self.blank))[0], 0.0
            if T <= max(2 * beam_chunk_frames, 8192):
                prefixes, plens, scores = ctc_beam_search(
                    logits[None], beam_width=self.beam_width, blank=self.blank,
                    max_label_len=self.max_label_len or T, prune=self.cutoff_top_n)
                n = int(plens[0, 0])
                return (labels2strings([prefixes[0, 0, :n].cpu().numpy()])[0],
                        float(scores[0, 0]))
            labels, score, _ = streaming_beam_decode(
                logits, beam_width=self.beam_width, label_window=label_window,
                chunk_frames=beam_chunk_frames, blank=self.blank, log_input=False,
                cutoff_top_n=self.cutoff_top_n)
        return labels2strings([labels])[0], score

    def basecall_long_batch(self, signals, chunk_len: int = 16384,
                            margin: Optional[int] = None, chunk_batch: int = 8,
                            beam_chunk_frames: int = 4096, label_window: int = 2048
                            ) -> Tuple[List[str], List[float]]:
        """Basecall a BATCH of equal-length long reads (B, L, C): chunked
        forwards of all reads on one grid, then one streaming beam for the
        batch (``StreamingBeamBatch``), one beam call a chunk of
        ``beam_chunk_frames`` frames, the last chunk padded. Sets
        ``saturated_chunks``, the decoder's count of (chunk, read) pairs
        whose label window was full."""
        with torch.inference_mode():
            sigs = torch.as_tensor(np.asarray(signals, np.float32)).to(self.device)
            logits = chunked_logits_batch(self.model, sigs, chunk_len, margin, chunk_batch)
            B, T, C = logits.shape
            if self.beam_width <= 0:
                labels = argmax_decode(logits).cpu().numpy()
                return labels2strings(ctc_collapse(labels, blank=self.blank)), [0.0] * B
            lp = torch.log_softmax(logits, dim=-1)
            sbb = StreamingBeamBatch(B, np.full((B,), T, np.int32), beam_width=self.beam_width,
                                     label_window=label_window, blank=self.blank,
                                     cutoff_top_n=self.cutoff_top_n, device=self.device)
            for s in range(0, T, beam_chunk_frames):
                chunk = lp[:, s: s + beam_chunk_frames]
                if chunk.shape[1] < beam_chunk_frames:
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (B, beam_chunk_frames - chunk.shape[1], C))], dim=1)
                sbb.feed(chunk)
            out = sbb.finalize()
        self.saturated_chunks = sbb.saturated_chunks
        return labels2strings([labels for labels, _, _ in out]), [s for _, s, _ in out]


def _default_margin(model) -> int:
    """Edge-contamination width of one forward: frames closer than this to a
    chunk boundary may differ from the whole signal's forward. Conservative:
    the full receptive field of the conv stack plus the featurizer's or the
    entry conv's (inference.py:193-206)."""
    m = 0
    if hasattr(model, "feature_kwidth"):
        m += model.feature_kwidth - 1
    if hasattr(model, "entry_kwidth"):
        m += model.entry_kwidth - 1
    for (_, _, k, d) in getattr(model, "layers", ()):
        m += (k - 1) * d
    return m


def _check_chunk_len(chunk_len: int, margin: int) -> None:
    if chunk_len <= 2 * margin:
        raise ValueError(f"chunk_len {chunk_len} must exceed 2*margin ({2 * margin})")


def output_extension(model, L: int) -> int:
    """output_length(L) - L, the frames the model adds to a read of L
    samples; ValueError for a model whose frames do not follow its samples
    one to one (a pooled head, the transformer's strided stem)."""
    extra = int(model.output_length(L)) - L
    if int(model.output_length(2 * L)) - 2 * L != extra:
        raise ValueError(
            f"chunked forwards need one logit frame a sample, but this model "
            f"emits output_length({L}) = {model.output_length(L)} "
            f"frames (a pooled head: L // pool; a strided stem: L over its stride): "
            f"the chunk grid counts samples, so its slices would not tile the logits "
            f"(the JAX package fails its stitching check there, inference.py:252)")
    return extra


def _chunk_grid(model, L: int, chunk_len: int, margin: int):
    """The overlapping-chunk plan for one read length (inference.py:301-328):
    chunk start offsets, each chunk's kept (lo, hi) output slice (they tile
    [0, L_out) exactly), and the model's output-length extension. A model
    whose output frames do not follow its samples one to one (a pooled
    head) is refused."""
    _check_chunk_len(chunk_len, margin)
    extra = output_extension(model, chunk_len) if hasattr(model, "output_length") else 0
    step = chunk_len - 2 * margin
    starts = list(range(0, L - chunk_len + step, step))
    # right-align the last chunk so every raw sample is covered
    if starts[-1] + chunk_len < L:
        starts.append(L - chunk_len)
    starts[-1] = min(starts[-1], L - chunk_len)

    bounds = []
    pos = 0  # next global output frame to emit
    for i, s in enumerate(starts):
        lo = pos - s
        hi = (chunk_len + extra if i == len(starts) - 1
              else chunk_len + extra - margin)
        if i < len(starts) - 1:  # keep at most up to the next chunk's kept start
            hi = min(hi, starts[i + 1] + margin - s)
        hi = max(hi, lo)  # a fully shadowed chunk contributes nothing
        bounds.append((lo, hi))
        pos = s + hi
    return starts, bounds, extra


def _model_device(model) -> torch.device:
    if isinstance(getattr(model, "device", None), torch.device):
        return model.device
    return next(model.parameters()).device


def _run_chunk_fwd(model, chunks: torch.Tensor, chunk_batch: int) -> torch.Tensor:
    """(N, chunk_len, C) chunks through the model in groups of chunk_batch,
    the tail group zero-padded so every forward has one shape."""
    N = chunks.shape[0]
    pad_n = (-N) % chunk_batch
    if pad_n:
        chunks = torch.cat([chunks, chunks.new_zeros((pad_n,) + chunks.shape[1:])])
    outs = [model(chunks[i: i + chunk_batch]) for i in range(0, chunks.shape[0], chunk_batch)]
    return torch.cat(outs)[:N]


def chunked_logits(model, signal, chunk_len: int, margin: Optional[int] = None,
                   chunk_batch: int = 8) -> torch.Tensor:
    """Logits of ONE long read (L, C) through overlapping chunks
    (inference.py:220-253): chunks of ``chunk_len`` samples overlapping by
    2 margin run through the model ``chunk_batch`` at a time; the margin
    frames are trimmed at interior boundaries and the kept slices tile the
    monolithic forward's logits (equal to it up to the order of float
    sums). margin defaults to ``_default_margin(model)``.

    Returns (L_out, labels) on the model's device, L_out =
    model.output_length(L) where the model has one, else L."""
    with torch.inference_mode():
        signal = torch.as_tensor(signal, dtype=torch.float32).to(_model_device(model))
        L = signal.shape[0]
        margin = _default_margin(model) if margin is None else int(margin)
        _check_chunk_len(chunk_len, margin)
        if L <= chunk_len:  # short read: one forward
            return model(signal[None])[0]
        starts, bounds, extra = _chunk_grid(model, L, chunk_len, margin)
        out = _run_chunk_fwd(model, torch.stack([signal[s: s + chunk_len] for s in starts]),
                             chunk_batch)
        stitched = torch.cat([out[i, lo:hi] for i, (lo, hi) in enumerate(bounds)])
    if stitched.shape[0] != L + extra:
        raise AssertionError(f"stitched {stitched.shape[0]} frames, expected {L + extra}")
    return stitched


def chunked_logits_batch(model, signals, chunk_len: int, margin: Optional[int] = None,
                         chunk_batch: int = 8) -> torch.Tensor:
    """Logits of a BATCH of equal-length long reads (B, L, C)
    (inference.py:256-292): every read shares one chunk grid, so all B n
    chunks run through the same (chunk_batch, chunk_len, C) forward; each
    read's logits equal ``chunked_logits``' of it. Returns (B, L_out,
    labels) on the model's device."""
    with torch.inference_mode():
        sigs = torch.as_tensor(signals, dtype=torch.float32).to(_model_device(model))
        B, L, _ = sigs.shape
        margin = _default_margin(model) if margin is None else int(margin)
        _check_chunk_len(chunk_len, margin)
        if L <= chunk_len:  # short reads: plain batched forwards
            return _run_chunk_fwd(model, sigs, chunk_batch)
        starts, bounds, extra = _chunk_grid(model, L, chunk_len, margin)
        n = len(starts)
        # read-major: row b * n + i is read b, chunk i
        chunks = torch.stack([sigs[b, s: s + chunk_len] for b in range(B) for s in starts])
        out = _run_chunk_fwd(model, chunks, chunk_batch)
        out = out.reshape(B, n, *out.shape[1:])
        stitched = torch.cat([out[:, i, lo:hi] for i, (lo, hi) in enumerate(bounds)], dim=1)
    if stitched.shape[1] != L + extra:
        raise AssertionError(f"stitched {stitched.shape[1]} frames, expected {L + extra}")
    return stitched

"""The training window: the port's train step (the family's
``make_step``), one step a call, each batch moved by
``data.prefetch.batch_to_device`` from a pool of host batches made at
set-up and cycled. Nothing is read back inside the window.

Set-up builds one train state, drives it through the first three steps on
pool batches 0-2 (rows that all differ), records what the check compares,
and hands that same state to the window, which goes on from batch 3. The
first gradient is read as the optimizer gets it, by a wrapper around the
optimizer's update that keeps the norms of its first call's gradients
(Adagrad's accumulator starts at 0.1, so the gradient cannot be read back
from its state in float32)."""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch
from wavenet_speech_tpu_torch.data.common import Batch
from wavenet_speech_tpu_torch.data.prefetch import batch_to_device
from wavenet_speech_tpu_torch.training import TrainState

from h100_bench import gen, weights
from h100_bench.compare import train_numbers
from h100_bench.counts.model import forward_flops
from h100_bench.port import family
from h100_bench.reference.train import follow

CHECK_STEPS = 3


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a.b": leaf} of a nested dict, in its order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _norms(tree) -> Dict[str, torch.Tensor]:
    return {k: torch.linalg.vector_norm(v.double()) for k, v in flatten(tree).items()}


class _FirstGradient:
    """An optimizer whose first update also keeps the norms of the
    gradients it was given."""

    def __init__(self, tx):
        self.tx, self.norms = tx, None
        self.wrapped = type(tx)(tx.init, self.update)

    def update(self, updates, state, params=None):
        if self.norms is None:
            self.norms = _norms(updates)
        return self.tx.update(updates, state, params)


class Loop:
    def __init__(self, cfg, mix, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.fam = family(cfg["family"])

    # -- set-up ---------------------------------------------------------
    def setup(self):
        self.pool = gen.make(self.mix, self.seed)
        flat = weights.make(self.cfg, self.seed, self.device)
        self.model = self.fam.build(self.cfg, self.device)
        params = self.fam.load(self.model, flat)
        del flat
        recorder = _FirstGradient(self.fam.optimizer(self.cfg))
        self.step = self.fam.make_step(self.cfg, self.model, recorder.wrapped)
        state0 = TrainState.create(params, recorder.wrapped)
        state, losses = state0, []
        for i in range(CHECK_STEPS):
            state, m = self.step(state, self._feed(i))
            losses.append(m["total_loss"])
        p0, p3 = flatten(state0.params), flatten(state.params)
        self.prog = {"losses": torch.stack(losses),
                     "grad_norms": recorder.norms,
                     "change_norms": {k: torch.linalg.vector_norm((p3[k] - p0[k]).double())
                                      for k in p0}}
        del state0, p0, p3
        self.state, self.next = state, CHECK_STEPS
        self.skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        per_batch = forward_flops(self.cfg, [self.pool[0]["signal"].shape[1]]) \
            * self.pool[0]["signal"].shape[0]
        self.flops_per_step = 3.0 * per_batch
        self._sync()

    def _feed(self, i: int):
        return batch_to_device(Batch(**self.pool[i % len(self.pool)]), self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _one(self, span=contextlib.nullcontext):
        i = self.next
        with span("bench.feed"):
            batch = self._feed(i)
        with span("bench.step"):
            self.state, m = self.step(self.state, batch)
        if "skipped_nonfinite" in m:
            self.skipped += m["skipped_nonfinite"]
        self.next += 1
        return int(self.pool[i % len(self.pool)]["signal_lengths"].sum())

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> Dict:
        self._sync()
        t0 = time.perf_counter()
        steps, samples = 0, 0
        while True:
            samples += self._one()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        dt = time.perf_counter() - t0
        failed = int(self.skipped)
        return {"seconds": dt, "attempted": steps, "failed": failed,
                "flops": steps * self.flops_per_step,
                "metrics": {"train_samples_per_s": samples / dt}}

    def traced(self, span) -> Dict:
        n = self.mix.get("trace_steps", 3)
        rows = 0
        for _ in range(n):
            shape = self.pool[self.next % len(self.pool)]["signal"].shape
            rows += shape[0] * shape[1]
            self._one(span)
        self._sync()
        return {"steps": n, "rows": rows}

    def release(self):
        """Free the program's state before the reference runs."""
        self.prog = {"losses": [float(x) for x in self.prog["losses"].cpu()],
                     "grad_norms": {k: float(v) for k, v in self.prog["grad_norms"].items()},
                     "change_norms": {k: float(v) for k, v in self.prog["change_norms"].items()}}
        del self.state, self.model, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def reference(self, tf32: bool = False) -> Dict:
        """The reference's readings of the first steps, float32 (TF32 with
        tf32=True: the control's precision)."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            params0 = weights.make(self.cfg, self.seed, self.device)
            return follow(self.cfg, params0, self.pool[:CHECK_STEPS], self.device)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    def check(self) -> Dict[str, float]:
        self.ref_readings = self.reference()
        return train_numbers(self.prog, self.ref_readings)

"""The basecall window: one client, a closed loop of ``Basecaller`` calls
(the family's ``basecaller``) over a pool of batches made at set-up, each
call handed its batch's one-hot signal (B, L_max, levels) and true
lengths, and timed from the hand-over to the strings' return.

Set-up makes every call of the pool once, so every bucketed shape is warm
before the window. A forward hook on the model keeps a reference to the
logits of each call of the window (no copy). After the window the check
draws a sample of the answers the window returned, the longest read among
them, and compares each with the reference in two stages: the logits
with the plain forward over the read padded as the call padded it (the
batch's longest read, then the bucket), and the string and score with the
float64 prefix beam over the read's own frames of the program's logits.
The beam follows the program's logits and not the reference's because a
beam of 7 over ~1,500 frames is chaotic: where two implementations' logits
differ by rounding, a tie at the seventh place can change the best prefix,
so the decoder is held to the same input it was given."""
from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from h100_bench import gen, reference, weights
from h100_bench.compare import basecall_numbers
from h100_bench.counts.model import forward_flops
from h100_bench.port import family
from h100_bench.reference.beam import log_softmax64, prefix_beam


class Loop:
    def __init__(self, cfg, mix, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        self.fam = family(cfg["family"])
        self.ref_family = reference.family(cfg["family"])

    def setup(self):
        self.pool = gen.make(self.mix, self.seed)
        flat = weights.make(self.cfg, self.seed, self.device)
        self.model = self.fam.build(self.cfg, self.device)
        self.fam.load(self.model, flat)
        del flat
        self.caller = self.fam.basecaller(self.cfg, self.model, self.mix, self.device)
        for i in range(len(self.pool)):
            self.call(i)
        self.answers, self.logits = [], []
        self.model.register_forward_hook(lambda mod, args, out: self.logits.append(out))

    def call(self, i: int):
        """The Basecaller's answer to pool batch i (cycled)."""
        b = self.pool[i % len(self.pool)]
        return self.caller(b["signal"], lengths=b["signal_lengths"])

    def window(self, seconds: float) -> Dict:
        lat, samples, reads = [], 0, 0
        t0 = time.perf_counter()
        i = 0
        while True:
            s = time.perf_counter()
            out = self.call(i)
            e = time.perf_counter()
            lat.append(e - s)
            self.answers.append((i % len(self.pool), out))
            b = self.pool[i % len(self.pool)]
            samples += int(b["signal_lengths"].sum())
            reads += len(b["signal_lengths"])
            i += 1
            if e - t0 >= seconds:
                break
        dt = e - t0
        lens = [l for k, _ in self.answers for l in self.pool[k]["signal_lengths"]]
        return {"seconds": dt, "attempted": reads, "failed": 0,
                "flops": forward_flops(self.cfg, lens),
                "metrics": {"basecall_samples_per_s": samples / dt,
                            "basecall_p95_ms": 1e3 * float(np.percentile(lat, 95))}}

    def traced(self, span) -> Dict:
        n = self.mix.get("trace_calls", 12)
        lens = []
        for i in range(n):
            with span("bench.call"):
                self.call(i)
            lens.extend(int(x) for x in self.pool[i % len(self.pool)]["signal_lengths"])
        return {"calls": n, "rows": sum(lens)}

    def release(self):
        """Keep the sampled answers' logits on the host; free the rest."""
        self.picked = self.sample()
        self.served = {(k, r, a): self.logits[a][r, :self.ref_family.frames(
            self.cfg, int(self.pool[k]["signal_lengths"][r]))].double().cpu().numpy()
            for k, r, a in self.picked}
        del self.caller, self.model, self.logits
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    def sample(self):
        """(pool batch, row, answer index) of the answers to compare: the
        longest read answered and a seeded draw of the others."""
        rows = [(k, r, a) for a, (k, _) in enumerate(self.answers)
                for r in range(len(self.pool[k]["signal_lengths"]))]
        longest = max(rows, key=lambda x: self.pool[x[0]]["signal_lengths"][x[1]])
        g = gen.rng(self.seed, 2)
        n = min(self.mix.get("check_reads", 24), len(rows))
        picked = [rows[j] for j in g.choice(len(rows), size=n, replace=False)]
        if longest not in picked:
            picked[0] = longest
        return picked

    def reference_logits(self, picked, tf32: bool = False):
        """{(pool batch, row): the reference's logits of the read's frames}."""
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            p = weights.make(self.cfg, self.seed, self.device)
            logits = {}
            m = self.mix["bucket"]
            with torch.no_grad():
                for k in sorted({k for k, _, _ in picked}):
                    rows = sorted({r for kk, r, _ in picked if kk == k})
                    b = self.pool[k]
                    Lp = int(math.ceil(b["signal"].shape[1] / m)) * m
                    x = torch.zeros((len(rows), Lp, b["signal"].shape[2]), device=self.device)
                    x[:, :b["signal"].shape[1]] = torch.as_tensor(b["signal"][rows],
                                                                  device=self.device)
                    out = self.ref_family.serve_logits(p, x, self.cfg)
                    for j, r in enumerate(rows):
                        T = self.ref_family.frames(self.cfg, int(b["signal_lengths"][r]))
                        logits[(k, r)] = out[j, :T].double().cpu().numpy()
            del p
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return logits

    def check(self) -> Dict[str, float]:
        ref = self.reference_logits(self.picked)
        W = self.mix["beam_width"]
        rows = [(self.served[(k, r, a)], ref[(k, r)], self.answers[a][1][0][r],
                 self.answers[a][1][1][r]) for k, r, a in self.picked]
        self.checked = {"answers": [(s, sc) for _, _, s, sc in rows],
                        "best": [prefix_beam(log_softmax64(lg), W)[0] for lg, _, _, _ in rows]}
        return basecall_numbers([(lg, rl) for lg, rl, _, _ in rows], self.checked["answers"],
                                self.checked["best"])

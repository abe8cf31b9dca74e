"""Run-directory logger and meters (wavenet_speech_tpu/utils/run_logging.py):
``Logger`` makes run_dir/{ckpts/, logs/} and writes logs/training.log (the
reference's line format), logs/messages.log and logs/metrics.jsonl;
``MovingAverageMeter`` and ``Throughput`` (samples/s) feed them."""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional


class Logger:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.ckpt_dir = os.path.join(run_dir, "ckpts/")
        self.log_dir = os.path.join(run_dir, "logs/")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.log_dir, exist_ok=True)
        self.training_log = os.path.join(self.log_dir, "training.log")
        self.messages_log = os.path.join(self.log_dir, "messages.log")
        self.metrics_log = os.path.join(self.log_dir, "metrics.jsonl")
        self._files = {p: open(p, "a") for p in (self.training_log, self.messages_log,
                                                 self.metrics_log)}

    def close(self):
        for f in self._files.values():
            f.close()

    def _write(self, path: str, line: str):
        f = self._files[path]
        f.write(line)
        f.flush()

    def log(self, loss, step, train, valid):
        """The reference's line (utils/logging.py:46-47)."""
        self._write(self.training_log,
                    "{0} @ step: {1} | Training: {2:.4f} | Validation {3:.4f} \n".format(
                        loss, step, train, valid))

    def message(self, msg: str):
        self._write(self.messages_log, msg + "\n")

    def metrics(self, step: int, **kv):
        self._write(self.metrics_log, json.dumps({"step": step, **kv}) + "\n")


class MovingAverageMeter:
    """Windowed moving average."""

    def __init__(self, window: int = 5):
        self.values = collections.deque(maxlen=window)

    def add(self, v: float):
        self.values.append(float(v))

    @property
    def value(self) -> float:
        return sum(self.values) / len(self.values) if self.values else float("nan")


class Throughput:
    """samples/s over a sliding window of ticks."""

    def __init__(self, window: int = 20):
        self.times = collections.deque(maxlen=window)
        self.counts = collections.deque(maxlen=window)

    def tick(self, num_samples: int):
        self.times.append(time.perf_counter())
        self.counts.append(num_samples)

    @property
    def samples_per_sec(self) -> Optional[float]:
        if len(self.times) < 2:
            return None
        dt = self.times[-1] - self.times[0]
        n = sum(list(self.counts)[1:])
        return n / dt if dt > 0 else None

"""The plain reference the benchmark holds the port to: PyTorch and NumPy
written from the reference's equations, importing nothing of the port.

One module a model family (``reference/<family>.py``, by the
configuration's ``family``) and one a rule of the optimizer
(``reference/optim/<optimizer>.py``, by ``training.optimizer``), so that a
family or an optimizer is added as a file. ``nn.py`` holds the layers the
families share; ``train.py`` the step that drives them; ``ctc.py`` and
``beam.py`` the loss and the decoder."""
from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of a model family. A family module defines
    ``param_shapes(cfg)``, ``serve_logits(p, x, cfg)``, ``frames(cfg, L)``,
    ``prepare(cfg, batch)`` (the batch's tensors as the loss reads them)
    and ``loss_rows(cfg, p, batch, lo, hi)``."""
    return importlib.import_module(f"h100_bench.reference.{name}")


def optimizer(name: str):
    """The reference rule of an optimizer: ``init(params, training)`` and
    ``update(grads, state, training) -> (updates, state)``."""
    return importlib.import_module(f"h100_bench.reference.optim.{name}")


# the program precisions the reference is a yardstick for: it runs in
# float32 with TF32 off (the loss terms in float64), at or above each
PRECISIONS = ("float32", "bfloat16")


def precision(cfg) -> str:
    """The configuration's dtype, which has to be one the reference's own
    float32 lies at or above; any other raises."""
    dtype = cfg["dtype"]
    if dtype not in PRECISIONS:
        raise ValueError(f"the reference is no yardstick for dtype {dtype!r} "
                         f"(it runs float32; programs of {PRECISIONS})")
    return dtype

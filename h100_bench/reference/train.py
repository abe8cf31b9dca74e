"""The reference train step: the family's loss (``reference/<family>.py``),
autograd's gradients, the skip guard and the optimizer's rule
(``reference/optim/<optimizer>.py``), in plain PyTorch.

``follow`` runs the first steps from the seed's weights and returns what
the benchmark compares: each step's loss, the norm of each leaf's first
gradient as the optimizer gets it, and the norm of each leaf's change
after the last step."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from h100_bench import reference


ROWS = 8  # rows a block: the gradient is summed over blocks of rows, to fit


def _norms(tree) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def follow(cfg, params0: Dict[str, torch.Tensor], batches: List[Dict[str, np.ndarray]],
           device) -> Dict:
    """Run len(batches) guarded steps from params0 (not modified). Returns
    {"losses": [...], "grad_norms": {leaf: norm}, "change_norms": {leaf:
    norm}}."""
    reference.precision(cfg)
    fam = reference.family(cfg["family"])
    opt = reference.optimizer(cfg["training"]["optimizer"])
    params = {k: v.clone() for k, v in params0.items()}
    state = opt.init(params, cfg["training"])
    losses, grad_norms = [], None
    for batch in batches:
        dev = fam.prepare(cfg, {k: torch.as_tensor(v, device=device) for k, v in batch.items()})
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total, grads = 0.0, None
        for lo in range(0, dev["labels"].shape[0], ROWS):
            part = fam.loss_rows(cfg, leaves, dev, lo, lo + ROWS)
            g = torch.autograd.grad(part, list(leaves.values()), allow_unused=True,
                                    materialize_grads=True)
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
            total += float(part.detach())
            del part, g
        grads = dict(zip(leaves, grads))
        losses.append(total)
        ok = math.isfinite(total) and all(bool(torch.isfinite(g).all())
                                          for g in grads.values())
        if grad_norms is None:
            grad_norms = _norms(grads) if ok else {k: 0.0 for k in grads}
        if ok:
            ups, state = opt.update(grads, state, cfg["training"])
            params = {k: (params[k] + ups[k]).detach() for k in params}
        del leaves, grads
    change = _norms({k: params[k] - params0[k] for k in params})
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

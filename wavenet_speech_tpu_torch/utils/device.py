"""Device resolution for the port's entry points, and the port's CUDA
numerics."""
from __future__ import annotations

from typing import Optional, Union

import torch


def set_cuda_numerics() -> None:
    """The numerics every float32 op of the port runs with on the card, set
    for the process: full float32 in cuDNN's convs and cuBLAS's matmuls (no
    TF32), as the JAX package computes them in the tests that hold the
    port, and cuDNN's deterministic algorithms, so that one config and one
    seed train one model, as in the JAX package. The port's own kernels
    are float32-accurate and deterministic either way."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else ``cuda``.
    A CUDA device gets the port's numerics (``set_cuda_numerics``).

    With no device given and no CUDA device present this raises: the port
    never moves to the CPU on its own. Pass ``device="cpu"`` to run there
    (the kernels then use their plain PyTorch versions)."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        set_cuda_numerics()
    return dev

"""wavenet_speech_tpu_torch: the PyTorch/CUDA port of wavenet_speech_tpu.

This package grows beside the JAX package, slice by slice. It imports
``torch`` and numpy, never ``jax`` and nothing of ``wavenet_speech_tpu``:
the modules it needs from there are copied (utils/config.py,
utils/run_logging.py, data/common.py, data/pore_model.py).

Layout follows the JAX package: tensors are NLC (batch, length, channels),
conv kernels are (K, C_in, C_out) and dense kernels (C_in, C_out), so a JAX
param pytree loads unchanged through ``bridge.params_from_jax``.

Entry points (``facade.Model``, ``inference.Basecaller``, the ``train``
command of ``cli.py``) run on ``cuda`` unless the caller passes
``device="cpu"`` (``--device cpu``). The hand-written CUDA kernels
(``csrc/*.cu``) are compiled by ``ops/_build.py`` at their first CUDA call,
so importing this package needs neither a GPU nor ``nvcc``.
"""

__version__ = "0.1.0"

"""The benchmark of the PyTorch/CUDA port (``wavenet_speech_tpu_torch``) on
an NVIDIA H100. ``python3 -m h100_bench.run`` runs one cell of
``BENCHMARK.json``; ``python3 -m h100_bench.calibrate`` gives the readings
the correctness limits are set from. The harness is driven by data: a
configuration, a traffic mix, a cell's limits and a per-layer metric are
files of their own (``spec.py``), and so is what a model family or an
optimizer needs: ``port/<family>.py`` (how the port builds, trains and
serves it), ``reference/<family>.py``, ``reference/optim/<optimizer>.py``
and ``counts/<family>.py``. Only ``port/``, ``loops/`` and ``faults.py``
import the port; ``reference/``, ``gen.py``, ``weights.py``, ``counts/``
and ``compare.py`` import none of it."""

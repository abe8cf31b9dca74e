"""How the benchmark builds the system under test, one module a model
family (``port/<family>.py``), found by the configuration's ``family``.
These are the only modules of the benchmark that import the port."""
from __future__ import annotations

import importlib


def family(name: str):
    """The adapter module of a model family."""
    return importlib.import_module(f"h100_bench.port.{name}")

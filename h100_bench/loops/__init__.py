"""The loops a window drives, one module each (``loops/<loop>.py``), found
by the traffic file's ``loop``. A loop module defines ``Loop(cfg, mix,
seed, device)`` with ``setup()``, ``window(seconds)``,
``traced(span)``, ``release()`` and ``check()``."""
from __future__ import annotations

import importlib


def get(name: str):
    return importlib.import_module(f"h100_bench.loops.{name}").Loop

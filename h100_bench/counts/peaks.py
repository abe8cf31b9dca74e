"""The chip's published peaks (``peaks.json``), by device name."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

TABLE = Path(__file__).resolve().parent.parent / "peaks.json"


def lookup(kind: str) -> Optional[dict]:
    """{"flops": {dtype: FLOP/s}, "bytes_per_s": B/s} of the device named
    kind (matched by the table's key within the name), or None."""
    devices = json.loads(TABLE.read_text())["devices"]
    for key, peaks in devices.items():
        if key in kind:
            return peaks
    return None

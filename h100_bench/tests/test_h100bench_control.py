"""On the card, at each cell's own size: the control (the reference put
in the program's place in the precision below float32: TF32 products, a
bfloat16 beam) fails the cell's limits, and a sound run passes them. Run
on the chip with ``python3 -m pytest h100_bench/tests -m cuda``."""
from __future__ import annotations

import pytest

from h100_bench.calibrate import readings
from h100_bench.compare import judge
from h100_bench.spec import Bench

CELLS = ["train.wavenet_ctc", "train.raw_ctcnet", "basecall.wavenet_ctc"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cuda_device, cell):
    bench = Bench()
    limits = bench.limits(cell)
    assert not judge(readings(bench, cell, 2 ** 31 + 901, "control", cuda_device)[0], limits)
    assert judge(readings(bench, cell, 2 ** 31 + 902, "program", cuda_device)[0], limits)

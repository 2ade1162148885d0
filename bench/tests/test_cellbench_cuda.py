"""A cell's whole run on the card at a small size (marked ``cuda``; it
skips without a device):

    python -m pytest -m cuda bench/tests
"""
import time

import pytest
import torch

from bench import run
from bench.tests.test_cellbench_run import CELLS, tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, mix, e2e, layer = tiny_cell(cell)
    for trace in (False, True):
        result, _ = run.run_cell(cfg, mix, e2e, layer, seed=2**31 + 9,
                                 seconds=1.0, trace=trace,
                                 t0=time.perf_counter(), log=lambda m: None)
        assert result["correct"], result
        assert result["device"]["platform"] == "gpu"
        if trace:
            assert result["device"]["busy_s"] > 0

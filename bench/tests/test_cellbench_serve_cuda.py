"""``kron18.serve`` itself on the card (marked ``cuda``; it skips without a
device): its configuration and mix as ``BENCHMARK.json`` names them, the
window cut to 5 s.  The program comes out correct, and its control (the
landmark bound in the service's place) does not.

    python -m pytest -m cuda bench/tests/test_cellbench_serve_cuda.py -rP
"""
import time

import pytest
import torch

from bench import manifest, run, systems
from bench.tests.test_cellbench_run import M

CELL = "kron18.serve"
SECONDS = 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("system", [None, systems.Control],
                         ids=["program", "control"])
def test_kron18_serve_on_the_card(system):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w = manifest.workload(M, CELL)
    cfg = manifest.config(M, w["config"])
    mix = manifest.traffic(w["traffic"])
    e2e, layer = manifest.cell_metrics(M, CELL)
    logs = []
    result, checks = run.run_cell(cfg, mix, e2e, layer, seed=2**31 + 51,
                                  seconds=SECONDS, trace=False,
                                  t0=time.perf_counter(), system=system,
                                  log=logs.append)
    print("\n".join(logs))
    print(result)
    checks = {name: v for name, v, _, _ in checks}
    assert result["device"]["platform"] == "gpu"
    assert checks["rows_compared"] >= 1
    if system is None:
        assert result["correct"], result
        assert checks["wrong_entries"] == 0 and result["failed"] == 0
        assert checks["queries_compared"] >= 1000
    else:
        assert not result["correct"]
        assert checks["wrong_entries"] > 0
    torch.cuda.empty_cache()

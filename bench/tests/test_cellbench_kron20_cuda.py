"""``kron20.msbfs-4`` itself on four cards (marked ``cuda``; it skips with
fewer than four): Graph500 SCALE 20 on the (1, 4) mesh its configuration
names, under the ``msbfs1024`` mix, through :func:`bench.world.launch`
for 10 s, untraced.

    python -m pytest -m cuda bench/tests/test_cellbench_kron20_cuda.py -rP
"""
import json

import pytest
import torch

from bench import manifest, world
from bench.tests.test_cellbench_run import M

CELL = "kron20.msbfs-4"


@pytest.mark.cuda
def test_kron20_over_four_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    w = manifest.workload(M, CELL)
    e2e, layer = manifest.cell_metrics(M, CELL)
    cell = {"config": manifest.config(M, w["config"]),
            "mix": manifest.traffic(w["traffic"]), "e2e": e2e,
            "layer": layer, "seed": 2**31 + 41, "seconds": 10.0,
            "trace": False, "device": "cuda", "system": world.SYSTEM,
            "t0": world.monotonic()}
    path = tmp_path / "kron20.err"
    with open(path, "w") as f:
        rc, out = world.launch(cell, err=f)
    err = path.read_text()
    print(err[-8000:])
    print(out)
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"], result
    checks = result["checks"]
    assert checks["wrong_entries"]["value"] == 0
    assert checks["failed_calls"]["value"] == 0
    assert checks["rows_compared"]["value"] >= 1
    device = result["device"]
    assert device["platform"] == "gpu" and device["count"] == 4
    assert result["metrics"]["peak_mem_gib"]["value"] <= 72

"""The multi-rank path on four cards (marked ``cuda``; it skips with fewer
than four): ``kron18``'s configuration on a (1, 4) mesh under the
``msbfs1024`` mix, through :func:`bench.world.launch` for 10 s, untraced
and then traced.  A rehearsal of the path, not a cell: ``kron18`` fits
one card whole.

    python -m pytest -m cuda bench/tests/test_cellbench_world_cuda.py -rP
"""
import json

import pytest
import torch

from bench import manifest, world
from bench.tests.test_cellbench_run import M

CELL = "kron18.msbfs"
MESH = {"shape": [1, 4], "axes": ["data", "model"]}
TRACED = {"sparse_sweep_pct.msbfs", "sweep_us.msbfs", "sweep_span_us.msbfs",
          "call_roofline.msbfs", "device_idle_pct.msbfs"}


@pytest.mark.cuda
def test_kron18_over_four_cards(tmp_path):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    w = manifest.workload(M, CELL)
    e2e, layer = manifest.cell_metrics(M, CELL)
    for trace in (False, True):
        cell = {"config": dict(manifest.config(M, w["config"]), mesh=MESH),
                "mix": manifest.traffic(w["traffic"]), "e2e": e2e,
                "layer": layer, "seed": 2**31 + 17 + trace, "seconds": 10.0,
                "trace": trace, "device": "cuda", "system": world.SYSTEM,
                "t0": world.monotonic()}
        path = tmp_path / f"trace{int(trace)}.err"
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
        assert checks["rows_compared"]["value"] >= 1
        device = result["device"]
        assert device["platform"] == "gpu" and device["count"] == 4
        line = next(x for x in err.splitlines()
                    if x.startswith("peak memory by rank: "))
        peaks = json.loads(line.split(": ", 1)[1].removesuffix(" B"))
        assert len(peaks) == 4 and device["memory_peak_bytes"] == max(peaks)
        if trace:
            assert TRACED <= set(result["metrics"]), result["metrics"]
            assert device["busy_s"] > 0
        else:
            assert result["metrics"]["peak_mem_gib"]["value"] == \
                max(peaks) / 2**30

#!/usr/bin/env python3
"""Time the fused boolean kernel (K3) at each tile shape, and the int8
tensor-core push (K4) beside the fp16 ``torch.matmul`` of the same
product, on one NVIDIA GPU.

    python3 tools/probe_fused_boolean.py [--grid-sweeps 200] [--run 32]

K3 runs at every (tile rows, cluster CTAs) pair in ``SHAPES`` on two
states of the smoke graphs (``chip_smoke.py``), 128 sources each: rmat16
after 2 sweeps (4 sweeps per launch) and grid256 after ``--grid-sweeps``
sweeps (``--run`` sweeps per launch).  Every launch is held bit-identical
to the plain version.  Prints one JSON line per measurement, with the
card's name and power limit, and how many clusters of each shape the card
runs at once.  Needs CUDA; builds the kernels from ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((32, 16), (16, 16), (32, 8), (16, 8))


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid-sweeps", type=int, default=200)
    ap.add_argument("--run", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.core.engine import EngineConfig, apsp_engine_blocks
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import bovm
    from repro_torch.kernels.bovm import kernel as K
    from repro_torch.kernels.bovm import ref as R

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    rng = np.random.default_rng(1)
    graphs = {
        "rmat16": (gen.rmat(16, 16, directed=False, seed=1, device="cuda"),
                   2, 4),
        "grid256": (gen.grid2d(256, 256, device="cuda"), args.grid_sweeps,
                    args.run),
    }
    for name, (g, steps, n_run) in graphs.items():
        pg = repro_torch.prepare(g).prepared()
        srcs = np.sort(rng.choice(g.n_nodes, 128, replace=False))
        _, _, st = next(apsp_engine_blocks(pg, srcs, config=EngineConfig(
            mode="pull", use_kernel=True, max_steps=steps)))
        f, d, at = st.frontier.contiguous(), st.dist.contiguous(), \
            pg.adj_pull
        want = R.fused_boolean_multisweep_ref(f, at, d, steps, n_run)
        for rows, cluster in SHAPES:
            K.FUSED_ROWS, K.FUSED_CLUSTER = rows, cluster

            def k3():
                return bovm.fused_boolean_multisweep(
                    f, at, d, steps, n_run, bs=128, max_sweeps=n_run)

            got = k3()
            same = (torch.equal(want[0], got[0])
                    and torch.equal(want[1], got[1])
                    and int(want[2]) == int(got[2])
                    and bool(want[3]) == bool(got[3]))
            print(json.dumps({
                "kernel": "fused_boolean_multisweep", "graph": name,
                "after_sweeps": steps, "n_run": n_run, "rows": rows,
                "cluster": cluster, "ctas": cluster * -(-128 // rows),
                "active_clusters": K.fused_active_clusters(128, pg.n_pad,
                                                           rows, cluster),
                "prod": int(want[2]), "match": same,
                "ms": cuda_ms(torch, k3, 3)}), flush=True)
            if not same:
                return 1
        if name == "rmat16":
            adj = pg.adj
            for bk in (128, 32):
                def k4():
                    return bovm.fused_sweep(f, adj, d, steps + 1, bs=128,
                                            bn=128, bk=bk)
                same = all(torch.equal(a, b) for a, b in
                           zip(k4(), R.sweep_ref(f, adj, d, steps + 1)))
                print(json.dumps({"kernel": "fused_sweep", "bk": bk,
                                  "match": same,
                                  "ms": cuda_ms(torch, k4, 5)}), flush=True)
            lf, la = f.to(torch.float16), adj.to(torch.float16)
            print(json.dumps({"library": "fp16 torch.matmul", "ms": cuda_ms(
                torch, lambda: torch.matmul(lf, la), 5)}), flush=True)
            del lf, la, adj
        del pg, at, f, d, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

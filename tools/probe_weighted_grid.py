#!/usr/bin/env python3
"""Time the weighted engine on grid256 on one NVIDIA GPU: the default
(dynamic) run and the pinned sparse run, then K7 and K9 alone on the
first thin frontiers, where the dynamic switch picks K7.

    python3 tools/probe_weighted_grid.py [--root DIR] [--profile]

grid256 (``grid2d(256, 256)``) with ``chip_smoke.py``'s lane weights
(``integers(4, 33) / 8``) and its 128 sources, both drawn from seed 1
after rmat16's.  Three
default runs and two sparse runs, each on a freshly prepared graph with
its operands and live-word index built beforehand (host clock around a
synchronize); ``--root`` runs the package of another checkout (to hold
two trees against each other in one call); ``--profile`` adds a
``torch.profiler`` table of one more default run.  One line per
measurement, after the card's name and power limit.  Needs CUDA; builds
the kernels from the checkout's sources.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root) / "src"))
    import repro_torch
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import tropical

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "root": args.root}), flush=True)
    # chip_smoke.py's draws: rmat16's sources and lane weights come first
    rmat = gen.rmat(16, 16, directed=False, seed=1, device="cuda")
    g = gen.grid2d(256, 256, device="cuda")
    rng, wrng = np.random.default_rng(1), np.random.default_rng(1)
    rng.choice(rmat.n_nodes, 1024, replace=False)
    wrng.integers(4, 33, rmat.m_pad)
    srcs = np.sort(rng.choice(g.n_nodes, 128, replace=False)) \
        .astype(np.int32)
    lanes = (wrng.integers(4, 33, g.m_pad) / 8).astype(np.float32)
    del rmat

    def run(opts):
        h = repro_torch.prepare(g, weights=lanes, **opts)
        pw = h.prepared_weighted()
        if not opts:
            pw.wdense
            getattr(pw, "wdense_index", None)    # absent before the index
        getattr(pw, "relax_index", None)         # absent in older trees
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = h.apsp(srcs, semiring="tropical")
        torch.cuda.synchronize()
        return h, time.perf_counter() - t0, res

    h = None
    for opts, reps in (({}, 3), (dict(mode="sparse", use_kernel=True), 2)):
        for _ in range(reps):
            h_, sec, res = run(opts)
            h = h if opts else h_
            print(json.dumps({"run": "default" if not opts else "sparse",
                              "seconds": sec, "sweeps": res.sweeps,
                              "direction_counts":
                                  res.direction_counts.tolist()}),
                  flush=True)
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            h.apsp(srcs, semiring="tropical")
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=12))
    pw = h.prepared_weighted()
    if not hasattr(pw, "wdense_index"):
        return 0
    n, s = pw.n_pad, len(srcs)
    f = torch.zeros((s, n), dtype=torch.int8, device="cuda")
    f[torch.arange(s, device="cuda"),
      torch.from_numpy(srcs.astype(np.int64)).cuda()] = 1
    d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
    # a tree from before the in-lane index builds K9's lane order itself
    relax = {"index": pw.relax_index} if hasattr(pw, "relax_index") else {}
    inf = torch.tensor(float("inf"), device="cuda")
    for sweep in range(4):
        fd = torch.where(f != 0, d, inf)
        kernels = {
            "fused_minplus_sweep": lambda: tropical.fused_minplus_sweep(
                fd, pw.wdense, d, pw.w_edges.min(), index=pw.wdense_index),
            "sparse_relax_sweep": lambda: tropical.sparse_relax_sweep(
                f, d, g.src, g.dst, pw.w_edges, **relax)}
        for name, fn in kernels.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            print(json.dumps({"kernel": name, "after_sweeps": sweep,
                              "wall_ms": (time.perf_counter() - t0) / 10
                              * 1e3}), flush=True)
        f, d = kernels["sparse_relax_sweep"]()
    return 0


if __name__ == "__main__":
    sys.exit(main())

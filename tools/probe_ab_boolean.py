#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s rmat16 boolean default run, repeated, on one
NVIDIA GPU, so that two checkouts can be held against each other over
several processes.

    python3 tools/probe_ab_boolean.py [--root other/checkout] [--reps 5]

The run is the smoke's: ``rmat(16, 16, directed=False, seed=1)``, its
1,024 sources of seed 1, ``prepare(g)`` with the default options, the
pull operand and its index built beforehand (set-up), then
``h.apsp(sources)`` on the host clock around a synchronize.  Each
repetition takes a fresh handle, as the smoke's one run does; the first
is the process's first run of the engine, the one the smoke times.  The
kernels are built from the chosen tree's ``src`` before the first run.
Prints the card's name and power limit, then one JSON line per
repetition (seconds, sweeps, direction counts) and one with the first
run and the median of the others.  Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

sys.path.insert(0, str(ROOT))
from chip_smoke import SEED, nvidia_smi  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import _build

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": nvidia_smi(), "root": str(root)}),
          flush=True)
    sources_cu = sorted((root / "src" / "repro_torch").rglob("csrc/*.cu"))
    with ThreadPoolExecutor(len(sources_cu)) as pool:
        list(pool.map(_build.build, sources_cu))
    g = gen.rmat(16, 16, directed=False, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)    # the smoke's first draw
    srcs = np.sort(rng.choice(g.n_nodes, 1024, replace=False)) \
        .astype(np.int32)
    secs = []
    for rep in range(args.reps):
        h = repro_torch.prepare(g)
        h.prepared().adj_pull                    # operand build = set-up
        h.prepared().adj_pull_index
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = h.apsp(srcs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        print(json.dumps({"rep": rep, "seconds": secs[-1],
                          "sweeps": res.sweeps,
                          "direction_counts":
                              res.direction_counts.tolist()}), flush=True)
        del h, res
    print(json.dumps({"first": secs[0],
                      "median_rest": statistics.median(secs[1:])
                      if len(secs) > 1 else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

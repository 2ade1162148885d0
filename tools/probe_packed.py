#!/usr/bin/env python3
"""Time the packed push and pull sweeps (K1, K2) on one NVIDIA GPU at
``chip_smoke.py``'s two timed states, at several work shapes.

    python3 tools/probe_packed.py [--root other/checkout]

The states are ``chip_smoke.py``'s: rmat16 (``rmat(16, 16,
directed=False, seed=1)``, its first 128 sources of seed 1) after 2
sweeps and grid256 (``grid2d(256, 256)``, 128 sources of seed 1) after
200, reached by the sparse form.  Each kernel runs at every (short
column, work item) pair in ``SHAPES`` (the most index entries a column
walked by one thread has, the most entries of one warp's work item) with
the prepared live-word index, and is held bit-identical to its plain
version.  Also prints the index's build time and size and, at each
shape, the time of one call's launches replayed from a CUDA graph (the
device alone) and the device time per kernel that ``torch.profiler``
reads; at the default shape also the host's time to issue one call.
With ``--root`` it times that checkout's K1 and K2 as they are (a tree
from before the index takes none), so two trees can be held against
each other in one call.  One JSON line per measurement, after the card's
name and power limit.
Needs CUDA; builds the kernels from the chosen tree's ``src``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((32, 64), (0, 64), (8, 64), (16, 64), (24, 64), (48, 64),
          (32, 32), (32, 128))

sys.path.insert(0, str(ROOT))
# the smoke's timing helpers and thin state
from chip_smoke import GRID_STEPS, cuda_ms, graph_ms  # noqa: E402


def host_us(torch, fn, reps: int) -> float:
    """Host microseconds to issue one call (no synchronize between)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def profile_kernels(torch, fn, reps: int) -> dict:
    """Device microseconds per call of each kernel ``fn`` launches, as
    ``torch.profiler`` reads them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0)
        if t > 0:
            out[evt.key[:60]] = t / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose src/repro_torch is timed")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    from repro_torch.core.engine import EngineConfig, apsp_engine_blocks
    from repro_torch.core.frontier import pack_bits
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import bovm
    from repro_torch.kernels.bovm import kernel as K
    from repro_torch.kernels.bovm import ref as R

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "root": str(root)}), flush=True)
    takes_index = "index" in inspect.signature(
        bovm.packed_push_sweep).parameters
    rng = np.random.default_rng(1)
    graphs = {"rmat16": gen.rmat(16, 16, directed=False, seed=1,
                                 device="cuda"),
              "grid256": gen.grid2d(256, 256, device="cuda")}
    batch = {"rmat16": 1024, "grid256": 128}
    steps = {"rmat16": 2, "grid256": GRID_STEPS}
    for name, g in graphs.items():
        srcs = np.sort(rng.choice(g.n_nodes, batch[name], replace=False))
        pg = repro_torch.prepare(g).prepared()
        at = pg.adj_pull
        _, _, st = next(apsp_engine_blocks(pg, srcs[:128], config=EngineConfig(
            mode="sparse", max_steps=steps[name])))
        fp = pack_bits(st.frontier != 0)
        d = st.dist.contiguous()
        step = steps[name] + 1
        w = at.shape[1]
        wk = 4 if w % 8 else 8
        want = R.packed_pull_ref(fp, at, d, step)
        kw = {}
        if takes_index:
            idx = bovm.packed_live_words(at)
            kw = dict(index=idx)
            print(json.dumps({
                "graph": name, "index": "packed_live_words",
                "live_words": idx.words.numel(), "rows_live": idx.rows_live,
                "index_bytes": 4 * (idx.offsets.numel()
                                    + 2 * idx.words.numel()),
                "operand_bytes": at.numel() * 4,
                "ms": cuda_ms(torch, lambda: bovm.packed_live_words(at),
                              2)}), flush=True)
        default = (getattr(K, "SHORT_WORDS", None),
                   getattr(K, "ITEM_WORDS", None))
        for shape in SHAPES if takes_index else (default,):
            if takes_index:
                K.SHORT_WORDS, K.ITEM_WORDS = shape
            for kern, bs in ((bovm.packed_push_sweep, 128),
                             (bovm.packed_pull_sweep, 8)):
                def call(kern=kern, bs=bs):
                    return kern(fp, at, d, step, bs=bs, bn=128, wk=wk, **kw)
                got = call()
                same = all(torch.equal(a, b) for a, b in zip(want, got))
                row = {"graph": name, "kernel": kern.__name__,
                       "short_words": shape[0], "item_words": shape[1],
                       "match": same, "ms": cuda_ms(torch, call, 10),
                       "graph_ms": graph_ms(torch, call, 20),
                       "device_us": profile_kernels(torch, call, 5)}
                if shape == default:
                    row.update(host_us=host_us(torch, call, 20))
                print(json.dumps(row), flush=True)
                if not same:
                    return 1
        if takes_index:
            K.SHORT_WORDS, K.ITEM_WORDS = default
        del pg, at, st, fp, d, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

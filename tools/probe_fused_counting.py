#!/usr/bin/env python3
"""Time the fused counting kernel (K6) at each work shape on one NVIDIA
GPU, beside the live-word index it reads.

    python3 tools/probe_fused_counting.py [--run 4]

The state is ``chip_smoke.py``'s: rmat16 (``rmat(16, 16, directed=False,
seed=1)``), its first 128 sources of seed 1, after 2 counting sweeps;
each launch runs ``--run`` sweeps.  K6 runs at every (live words per work
item, blocks per SM) pair in ``SHAPES``, with all 128 rows in one launch
and as four launches of 32 rows (the rows then share no operand read).
Every launch is held bit-identical to the plain version.  Also prints the
index's build time and, per sweep, the index bytes a compacted word list
and a bitmap (n_pad / 128 bytes per operand row) would have the work
items read.  One JSON line per measurement, after the card's name and
power limit.  Needs CUDA; builds the kernels from ``src/repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((32, 2), (16, 2), (8, 2), (32, 1))       # (chunk, blocks / SM)


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
    ap.add_argument("--run", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.core.centrality import (CentralityConfig,
                                             counting_apsp_blocks)
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import counting
    from repro_torch.kernels.counting import kernel as K
    from repro_torch.kernels.counting import ref as CR

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    g = gen.rmat(16, 16, directed=False, seed=1, device="cuda")
    srcs = np.sort(np.random.default_rng(1).choice(g.n_nodes, 1024,
                                                   replace=False))[:128]
    pg = repro_torch.prepare(g).prepared()
    adj, n = pg.adj, pg.n_pad
    _, _, _, st = next(counting_apsp_blocks(pg, srcs, config=CentralityConfig(
        mode="push", use_kernel=True, max_steps=2)))
    f = st.frontier.contiguous()
    d, sg = (t.contiguous() for t in st.dist)
    idx = counting.nonzero_words(adj)
    print(json.dumps({"index": "nonzero_words", "n_pad": n,
                      "live_words": idx.words.numel(),
                      "rows_live": idx.rows_live,
                      "ms": cuda_ms(torch, lambda: counting.nonzero_words(adj),
                                    2)}), flush=True)

    # index bytes the work items read, per sweep: a word list against a
    # bitmap row, for every (k, 32-row group) with k in the group's frontier
    lens = (idx.offsets[1:] - idx.offsets[:-1]).double()
    ft, dt, sgt = f, d, sg
    for t in range(args.run):
        grp = (ft.reshape(4, 32, n) != 0).any(dim=1).double()   # (4, n)
        pairs = grp.sum(dim=0)
        print(json.dumps({"sweep": 3 + t, "union_rows": int((pairs > 0)
                                                             .sum()),
                          "group_rows": int(pairs.sum()),
                          "list_bytes": float(4 * pairs @ lens),
                          "bitmap_bytes": float(pairs.sum()) * n / 128}),
              flush=True)
        ft, dt, sgt = CR.counting_sweep_ref(torch.where(ft != 0, sgt, 0.0),
                                            adj, dt, sgt, 3 + t)
        if not bool(ft.any()):
            break

    want = CR.fused_counting_multisweep_ref(f, adj, d, sg, 2, args.run)
    for chunk, per_sm in SHAPES:
        K.CHUNK_WORDS, K.BLOCKS_PER_SM = chunk, per_sm
        for rows in (128, 32):
            def k6(rows=rows):
                return [counting.fused_counting_multisweep(
                    f[r: r + rows], adj, (d[r: r + rows], sg[r: r + rows]),
                    2, args.run, bs=rows, max_sweeps=args.run, index=idx)
                    for r in range(0, 128, rows)]
            got = k6()
            same = all(
                torch.equal(want[0][r: r + rows], o[0])
                and torch.equal(want[1][0][r: r + rows], o[1][0])
                and torch.equal(want[1][1][r: r + rows], o[1][1])
                for r, o in zip(range(0, 128, rows), got))
            print(json.dumps({
                "kernel": "fused_counting_multisweep", "chunk": chunk,
                "blocks_per_sm": per_sm, "rows_per_launch": rows,
                "launches": 128 // rows, "n_run": args.run,
                "prod": int(want[2]), "match": same,
                "ms": cuda_ms(torch, k6, 3)}), flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

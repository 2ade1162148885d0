#!/usr/bin/env python3
"""Time the dense min-plus push (K7) at each work shape on one NVIDIA GPU,
beside the live-word index it reads.

    python3 tools/probe_minplus.py

The state is ``chip_smoke.py``'s: rmat16 (``rmat(16, 16, directed=False,
seed=1)``) with lane weights ``integers(4, 33) / 8`` of seed 1, its first
128 sources of seed 1, after 2 sparse relax sweeps.  K7 runs at every
(live words per work item, push blocks per SM) pair in ``SHAPES``, with
all 128 rows in one launch and as four launches of 32 rows.  Every launch
is held bit-identical to the plain version.  Also prints the index's
build time and the index bytes a compacted word list and K8's bitmap
layout (n_pad / 32 bytes per operand row) would have the work items
read.  One JSON line per measurement, after the card's name and power
limit.  Needs CUDA; builds the kernels from ``src/repro_torch``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((32, 8), (16, 8), (8, 8), (32, 4), (32, 16))  # (chunk, blocks/SM)


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
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import tropical
    from repro_torch.kernels.tropical import kernel as K
    from repro_torch.kernels.tropical import ref as TR

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    g = gen.rmat(16, 16, directed=False, seed=1, device="cuda")
    srcs = np.sort(np.random.default_rng(1).choice(g.n_nodes, 1024,
                                                   replace=False))[:128]
    lanes = (np.random.default_rng(1).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    pw = repro_torch.prepare(g, weights=lanes).prepared_weighted()
    wd, lw, n = pw.wdense, pw.w_edges, pw.n_pad
    s = len(srcs)
    f = torch.zeros((s, n), dtype=torch.int8, device="cuda")
    f[torch.arange(s, device="cuda"),
      torch.from_numpy(srcs.astype(np.int64)).cuda()] = 1
    d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
    for _ in range(2):
        f, d = tropical.sparse_relax_sweep(f, d, g.src, g.dst, lw,
                                           index=pw.relax_index)
    fd = torch.where(f != 0, d, torch.tensor(float("inf"), device="cuda"))
    w_min = lw.min()
    idx = tropical.finite_words(wd)
    print(json.dumps({"index": "finite_words", "n_pad": n,
                      "live_words": idx.words.numel(),
                      "rows_live": idx.rows_live,
                      "ms": cuda_ms(torch, lambda: tropical.finite_words(wd),
                                    2)}), flush=True)
    lens = (idx.offsets[1:] - idx.offsets[:-1]).double()
    pairs = torch.isfinite(fd).reshape(4, 32, n).any(dim=1).double() \
        .sum(dim=0)
    print(json.dumps({"union_rows": int((pairs > 0).sum()),
                      "group_rows": int(pairs.sum()),
                      "list_bytes": float(4 * pairs @ lens),
                      "bitmap_bytes": float(pairs.sum()) * n / 32}),
          flush=True)

    want = TR.minplus_sweep_ref(fd, wd, d)
    for chunk, per_sm in SHAPES:
        K.CHUNK_WORDS, K.PUSH_BLOCKS_PER_SM = chunk, per_sm
        for rows in (128, 32):
            def k7(rows=rows):
                return [tropical.fused_minplus_sweep(
                    fd[r: r + rows], wd, d[r: r + rows], w_min, bs=rows,
                    bn=128, bk=128, index=idx) for r in range(0, s, rows)]
            got = k7()
            same = all(torch.equal(want[0][r: r + rows], o[0])
                       and torch.equal(want[1][r: r + rows], o[1])
                       for r, o in zip(range(0, s, rows), got))
            print(json.dumps({
                "kernel": "fused_minplus_sweep", "chunk": chunk,
                "blocks_per_sm": per_sm, "rows_per_launch": rows,
                "launches": s // rows, "match": same,
                "ms": cuda_ms(torch, k7, 5)}), flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

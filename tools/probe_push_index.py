#!/usr/bin/env python3
"""Time the counting push (K5) and the fused min-plus multi-sweep (K8)
over the live-word index at each work shape on one NVIDIA GPU.

    python3 tools/probe_push_index.py [--quick]

The states are ``chip_smoke.py``'s: rmat16 (``rmat(16, 16,
directed=False, seed=1)``), its first 128 sources of seed 1.  K5 runs on
the counting state after 2 pinned-push sweeps, K8 (4 sweeps a launch, and
0, 1, 2 to split its entry and exit from its sweeps) on the tropical state
after 2 sparse relax sweeps, with lane weights ``integers(4, 33) / 8`` of
seed 1.  Each runs at every (live words per work item, blocks per SM) pair
of its ``SHAPES``, and every call is held bit-identical to the plain
version (``--quick``: the first pair alone).  K5 also prints the device
time of each of its four kernels (``torch.profiler``).  One JSON line per measurement, after the card's
name and power limit.  Needs CUDA; builds the kernels from
``src/repro_torch``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
K5_SHAPES = ((16, 8), (8, 8), (32, 8), (16, 4), (16, 16))  # chunk, blocks/SM
K8_SHAPES = ((16, 8), (8, 8), (32, 8), (16, 4), (16, 2))


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


def same(a, b) -> bool:
    import torch
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def emit(**fields):
    print(json.dumps(fields), flush=True)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.core.centrality import (CentralityConfig,
                                             counting_apsp_blocks)
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import counting, tropical
    from repro_torch.kernels.counting import kernel as CK
    from repro_torch.kernels.counting import ref as CR
    from repro_torch.kernels.tropical import kernel as TK
    from repro_torch.kernels.tropical import ref as TR

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    g = gen.rmat(16, 16, directed=False, seed=1, device="cuda")
    srcs = np.sort(np.random.default_rng(1).choice(g.n_nodes, 1024,
                                                   replace=False))[:128]

    # -- K5 on the counting state ---------------------------------------
    pg = repro_torch.prepare(g).prepared()
    adj, n = pg.adj, pg.n_pad
    cidx = pg.adj_index
    _, _, _, st = next(counting_apsp_blocks(pg, srcs, config=CentralityConfig(
        mode="push", use_kernel=True, max_steps=2)))
    f = st.frontier.contiguous()
    d, sg = (t.contiguous() for t in st.dist)
    fs = torch.where(f != 0, sg, 0.0)
    want = CR.counting_sweep_ref(fs, adj, d, sg, 3)

    def k5():
        return counting.fused_counting_sweep(fs, adj, d, sg, 3, bs=128,
                                             index=cidx)

    quick = "--quick" in argv                # the first shape of each only
    for chunk, per_sm in K5_SHAPES[:1] if quick else K5_SHAPES:
        CK.CHUNK_WORDS, CK.PUSH_BLOCKS_PER_SM = chunk, per_sm
        ok = same(want, k5())
        emit(kernel="fused_counting_sweep", chunk=chunk, blocks_per_sm=per_sm,
             match=ok, ms=cuda_ms(torch, k5, 10))
        if not ok:
            return 1
    CK.CHUNK_WORDS, CK.PUSH_BLOCKS_PER_SM = K5_SHAPES[0]
    from torch.profiler import ProfilerActivity, profile
    k5()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            k5()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time", 0.0)
        if dev_us and ev.count >= 10 and "aten::" not in ev.key:
            emit(kernel="fused_counting_sweep", part=ev.key, calls=ev.count,
                 device_us_per_call=dev_us)
    del adj, cidx, pg, st, f, d, sg, fs, want
    torch.cuda.empty_cache()

    # -- K8 on the tropical state ---------------------------------------
    lanes = (np.random.default_rng(1).integers(4, 33, g.m_pad) / 8) \
        .astype(np.float32)
    pw = repro_torch.prepare(g, weights=lanes).prepared_weighted()
    wd, lw = pw.wdense, pw.w_edges
    widx = pw.wdense_index
    s = len(srcs)
    f = torch.zeros((s, n), dtype=torch.int8, device="cuda")
    f[torch.arange(s, device="cuda"),
      torch.from_numpy(srcs.astype(np.int64)).cuda()] = 1
    d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
    for _ in range(2):
        f, d = tropical.sparse_relax_sweep(f, d, g.src, g.dst, lw,
                                           index=pw.relax_index)
    wants = {n_run: TR.fused_minplus_multisweep_ref(f, wd, d, n_run)
             for n_run in (0, 1, 2, 4)}
    for chunk, per_sm in K8_SHAPES[:1] if quick else K8_SHAPES:
        TK.CHUNK_WORDS, TK.FUSED_BLOCKS_PER_SM = chunk, per_sm
        for n_run, want in wants.items():
            def k8(n_run=n_run):
                return tropical.fused_minplus_multisweep(
                    f, wd, d, 2, n_run, bs=128, max_sweeps=max(n_run, 1),
                    index=widx)
            ok = same(want, k8())
            emit(kernel="fused_minplus_multisweep", chunk=chunk,
                 blocks_per_sm=per_sm, n_run=n_run, match=ok,
                 ms=cuda_ms(torch, k8, 5))
            if not ok:
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

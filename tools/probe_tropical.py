#!/usr/bin/env python3
"""One short look at the tropical engine and its three kernels on the card.

    python3 tools/probe_tropical.py

rmat16 (as in ``chip_smoke.py``) with lane weights ``integers(4, 33) / 8``
and 128 sources from seed 1: a pinned-sparse ``weighted_apsp`` run (wall
seconds, sweeps), the dense operand's build time, then K7, K9 and K8 once
each on the state after 2 sparse sweeps (host clock around a
synchronize; K9 without lane offsets, so its wrapper sorts the lanes),
the plain K7, and a pinned-sparse run on grid256.  Prints one line per
measurement.  Needs one CUDA card and nvcc; it checks only that K7, K8
and K9 agree with each other after one sweep.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.weighted import (WeightedConfig,  # noqa: E402
                                       prepare_weighted, weighted_apsp)
from repro_torch.graph import generators as gen  # noqa: E402
from repro_torch.kernels import tropical  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_tropical: CUDA is not available", file=sys.stderr)
        return 2
    g = gen.rmat(16, 16, directed=False, seed=1, device="cuda")
    rng = np.random.default_rng(1)
    w = (rng.integers(4, 33, g.m_pad) / 8).astype(np.float32)
    pw = prepare_weighted(g, w)
    srcs = np.sort(rng.choice(g.n_nodes, 128, replace=False))
    cfg = WeightedConfig(mode="sparse", source_batch=128)
    res, sec = timed(lambda: weighted_apsp(pw, sources=srcs, config=cfg))
    print("sparse128", sec, res.sweeps, res.direction_counts.tolist(),
          float(res.edges_touched), flush=True)
    _, sec = timed(lambda: pw.wdense)
    print("wdense build", sec, flush=True)
    n = pw.n_pad
    f = torch.zeros((128, n), dtype=torch.int8, device="cuda")
    f[torch.arange(128), torch.from_numpy(srcs).cuda()] = 1
    d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
    for _ in range(2):
        f, d = tropical.sparse_relax_sweep(f, d, g.src, g.dst, pw.w_edges,
                                           index=pw.relax_index)
    print("frontier", int(f.sum()), "union", int((f != 0).any(0).sum()),
          flush=True)
    fd = torch.where(f != 0, d, torch.tensor(float("inf"), device="cuda"))
    w_min = pw.w_edges.min()

    widx = pw.wdense_index                # built once, as the engine does

    def k7():
        return tropical.fused_minplus_sweep(fd, pw.wdense, d, w_min,
                                            index=widx)

    out7, sec = timed(k7)
    print("K7 first", sec, flush=True)
    _, sec = timed(k7)
    print("K7", sec, flush=True)
    out9, sec = timed(lambda: tropical.sparse_relax_sweep(
        f, d, g.src, g.dst, pw.w_edges, index=pw.relax_index))
    print("K9", sec, torch.equal(out7[0], out9[0]),
          torch.equal(out7[1], out9[1]), flush=True)
    for n_run in (1, 4):
        out8, sec = timed(lambda: tropical.fused_minplus_multisweep(
            f, pw.wdense, d, 0, n_run, bs=128, max_sweeps=4, index=widx))
        print(f"K8 n_run={n_run}", sec, torch.equal(out8[1], out7[1]),
              int(out8[2]), bool(out8[3]), flush=True)
    _, sec = timed(lambda: tropical.minplus_sweep_ref(fd, pw.wdense, d))
    print("K7 plain", sec, flush=True)
    g2 = gen.grid2d(256, 256, device="cuda")
    w2 = (rng.integers(4, 33, g2.m_pad) / 8).astype(np.float32)
    pw2 = prepare_weighted(g2, w2)
    res, sec = timed(lambda: weighted_apsp(
        pw2, sources=np.arange(0, 65536, 512), config=cfg))
    print("grid sparse128", sec, res.sweeps, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

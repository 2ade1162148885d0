#!/usr/bin/env python3
"""Time the sparse relax (K9) on one NVIDIA GPU at ``chip_smoke.py``'s two
timed states: its two kernels' device time and the hub threshold swept.

    python3 tools/probe_relax.py [--root other/checkout]

The states are ``chip_smoke.py``'s: rmat16 (``rmat(16, 16,
directed=False, seed=1)``, lane weights ``integers(4, 33) / 8`` of seed
1, its first 128 sources of seed 1) after 2 sweeps and grid256
(``grid2d(256, 256)``, 128 sources of seed 1) after 200, reached by K9
from the one-hot start.  For each state it prints what the state asks of
a relax (frontier nodes per row; (lane, row) pairs whose source is in
the row's frontier at a finite distance, and those of them whose
candidate beats dist; (lane, group of 32 rows) pairs with such a source;
lanes of the sources in any row's frontier), the in-lane index's build
time, K9 at the default hub threshold and at each in ``HUBS`` (CUDA
events over 20 calls, each output held bit-identical to the plain
version), with the device microseconds per call of each kernel that
``torch.profiler`` reads (the entry, the hub pass where the index lists
pieces, the gather); at the default threshold also one call's launches
replayed from a CUDA graph (the device alone) and the host's time to
issue one call.  With ``--root`` it
times that checkout's K9 as it is (a tree from before the in-lane index
takes none), so two trees can be held against each other in one call.
One JSON line per measurement, after the card's name and power limit.
Needs CUDA; builds the kernels from the chosen tree's ``src``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HUBS = (16, 32, 64, 128, 256, 512, 1024, 4096, 1 << 30)
LANE_CHUNK = 1 << 16          # lanes per step of the beating-pair count

sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
# the smoke's timing helper and thin state, the packed probe's profiler
from chip_smoke import GRID_STEPS, cuda_ms, graph_ms  # noqa: E402
from probe_packed import host_us, profile_kernels  # noqa: E402


def state_counts(torch, f, d, g, lw) -> dict:
    """What one relax sweep on (f, d) asks for, over the graph's lanes
    below +inf weight."""
    keep = lw < float("inf")
    src, dst, w = g.src[keep].long(), g.dst[keep].long(), lw[keep]
    act = (f != 0) & torch.isfinite(d)                   # (S, n)
    s, n = act.shape
    deg = torch.bincount(src, minlength=n).double()
    groups = act.reshape(-1, 32, n).any(dim=1) if s % 32 == 0 else \
        torch.nn.functional.pad(act, (0, 0, 0, -s % 32)).reshape(
            -1, 32, n).any(dim=1)
    beats = 0
    for e0 in range(0, src.numel(), LANE_CHUNK):
        sl = slice(e0, e0 + LANE_CHUNK)
        a = act[:, src[sl]]
        c = d[:, src[sl]] + w[sl]
        beats += int((a & (c < d[:, dst[sl]])).sum())
    return {"frontier_nodes_per_row": float(act.sum()) / s,
            "lane_row_pairs": float(act.double().sum(dim=0) @ deg),
            "beating_pairs": beats,
            "lane_group_pairs": float(groups.double().sum(dim=0) @ deg),
            "union_lanes": float(act.any(dim=0).double() @ deg)}


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
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import tropical
    from repro_torch.kernels.tropical import kernel as K
    from repro_torch.kernels.tropical import ref as TR

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "root": str(root)}), flush=True)
    takes_index = "index" in inspect.signature(
        tropical.sparse_relax_sweep).parameters
    default = K.HUB_LANES if takes_index else None
    hubs = (default,) + tuple(h for h in HUBS if h != default) \
        if takes_index else (None,)
    # chip_smoke.py's draws: sources of both graphs, then lane weights
    rng, wrng = np.random.default_rng(1), np.random.default_rng(1)
    graphs = {"rmat16": gen.rmat(16, 16, directed=False, seed=1,
                                 device="cuda"),
              "grid256": gen.grid2d(256, 256, device="cuda")}
    batch = {"rmat16": 1024, "grid256": 128}
    steps = {"rmat16": 2, "grid256": GRID_STEPS}
    srcs = {name: np.sort(rng.choice(g.n_nodes, batch[name],
                                     replace=False))[:128]
            for name, g in graphs.items()}
    lanes = {name: (wrng.integers(4, 33, g.m_pad) / 8).astype(np.float32)
             for name, g in graphs.items()}
    for name, g in graphs.items():
        pw = repro_torch.prepare(g, weights=lanes[name]) \
            .prepared_weighted()
        lw, n = pw.w_edges, pw.n_pad
        kw = {}
        if takes_index:
            kw["index"] = pw.relax_index
            print(json.dumps({
                "graph": name, "index": "in_lanes",
                "lanes": int(kw["index"].offsets[-1]),
                "ms": cuda_ms(torch, lambda: tropical.in_lanes(
                    g.src, g.dst, lw, n), 5)}), flush=True)
        s = len(srcs[name])
        f = torch.zeros((s, n), dtype=torch.int8, device="cuda")
        f[torch.arange(s, device="cuda"),
          torch.from_numpy(srcs[name].astype(np.int64)).cuda()] = 1
        d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
        for _ in range(steps[name]):
            f, d = tropical.sparse_relax_sweep(f, d, g.src, g.dst, lw, **kw)
        print(json.dumps({"graph": name, "state": f"S={s}, after "
                          f"{steps[name]} sweeps",
                          **state_counts(torch, f, d, g, lw)}), flush=True)
        want = TR.sparse_relax_ref(f, d, g.src, g.dst, lw)

        def k9():
            return tropical.sparse_relax_sweep(f, d, g.src, g.dst, lw, **kw)

        for hub in hubs:
            if hub is not None:
                K.HUB_LANES = hub
                kw["index"] = tropical.in_lanes(g.src, g.dst, lw, n)
            got = k9()
            same = all(torch.equal(a, b) for a, b in zip(want, got))
            print(json.dumps({
                "graph": name, "kernel": "sparse_relax_sweep",
                "hub_lanes": hub, "hub_pieces": kw["index"].pieces.shape[0]
                if takes_index else None, "match": same,
                "ms": cuda_ms(torch, k9, 20),
                "device_us": profile_kernels(torch, k9, 10)}), flush=True)
            if not same:
                return 1
            if hub == default:
                host = host_us(torch, k9, 50)    # before any graph capture
                print(json.dumps({"graph": name, "hub_lanes": hub,
                                  "device_ms": graph_ms(torch, k9, 20),
                                  "host_us": host}), flush=True)
        if takes_index:
            K.HUB_LANES = default
        del pw, f, d, want, kw
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

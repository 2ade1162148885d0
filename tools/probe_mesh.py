#!/usr/bin/env python3
"""The sharded executor across several cards, one process per card.

    python -m torch.distributed.run --nproc-per-node=4 tools/probe_mesh.py
    python -m torch.distributed.run --nproc-per-node=4 tools/probe_mesh.py \\
        --device cpu --scale 9             # gloo, the plain versions

Every rank runs rmat13 (``rmat(13, 16, directed=False, seed=1)``; the
scale is ``--scale``; 256 sources of seed 1, lane weights ``integers(4,
33) / 8``) through ``sharded_apsp`` on the meshes (N,), (N / 2, 2) and
(1, N) ``(data, model)`` for the three semirings, dense and sparse, and
holds each result
bit for bit to the single-device engine's pinned run on its own device
(boolean push, counting push, tropical dense / sparse); on the card each
run must launch its kernel (K1, K5, K7, K9) on every rank.  Rank 0
prints one JSON line per run (seconds, sweeps, launches on rank 0) after
the card's name and power limit; any mismatch raises on its rank and the
launcher exits non-zero.
"""
from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEED = 1
KERNEL = {("boolean", "dense"): "packed_push_sweep",
          ("counting", "dense"): "fused_counting_sweep",
          ("tropical", "dense"): "fused_minplus_sweep",
          ("tropical", "sparse"): "sparse_relax_sweep"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--scale", type=int, default=13)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_mesh: CUDA is not available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core.distributed import ShardedConfig, sharded_apsp
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import bovm, counting, tropical
    from repro_torch.launch.mesh import make_mesh, mesh_device

    torch.set_num_threads(1)
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                            timeout=datetime.timedelta(seconds=120))
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        meshes = {f"{world}": make_mesh((world,), ("data",),
                                        device=args.device),
                  f"{world // 2}x2": make_mesh((world // 2, 2),
                                              ("data", "model"),
                                              device=args.device),
                  f"1x{world}": make_mesh((1, world), ("data", "model"),
                                          device=args.device)}
        dev = mesh_device(meshes[f"{world}"])
        if rank == 0 and dev.type == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip(), flush=True)
        g = gen.rmat(args.scale, 16, directed=False, seed=SEED, device=dev)
        w = (np.random.default_rng(SEED).integers(4, 33, g.m_pad) / 8) \
            .astype(np.float32)
        srcs = np.sort(np.random.default_rng(SEED).choice(
            g.n_nodes, 256, replace=False)).astype(np.int32)
        single = {}
        for sr, mode in (("boolean", "push"), ("counting", "push"),
                         ("tropical", "dense")):
            h = repro_torch.prepare(g, weights=w if sr == "tropical" else
                                    None, mode=mode, device=dev)
            single[sr] = h.apsp(srcs, semiring=sr)
        kernels = {k.__name__: k for k in (
            bovm.packed_push_sweep, counting.fused_counting_sweep,
            tropical.fused_minplus_sweep, tropical.sparse_relax_sweep)}
        for name, mesh in meshes.items():
            for sr in ("boolean", "counting", "tropical"):
                for mode in ("dense", "sparse"):
                    before = {k: f.launches for k, f in kernels.items()}
                    dist.barrier()
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = sharded_apsp(
                        g, srcs, mesh=mesh,
                        weights=w if sr == "tropical" else None,
                        config=ShardedConfig(semiring=sr, mode=mode))
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    got = {k: f.launches - before[k]
                           for k, f in kernels.items()}
                    ref = single[sr]
                    same = torch.equal(res.dist, ref.dist) and \
                        res.sweeps == ref.sweeps and (
                            sr != "counting"
                            or torch.equal(res.sigma, ref.sigma))
                    kernel = KERNEL.get((sr, mode))
                    if not same:
                        raise AssertionError(f"rank {rank}: {name}/{sr}/"
                                             f"{mode} differs")
                    if dev.type == "cuda" and kernel and got[kernel] < 1:
                        raise AssertionError(f"rank {rank}: {name}/{sr}/"
                                             f"{mode}: {kernel} never "
                                             f"launched")
                    if rank == 0:
                        print(json.dumps(dict(
                            mesh=name, semiring=sr, mode=mode,
                            seconds=wall, sweeps=res.sweeps,
                            direction_counts=res.direction_counts.tolist(),
                            launches_rank0={k: v for k, v in got.items()
                                            if v}, equal=True)), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ok": True, "world": world,
                          "device": args.device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

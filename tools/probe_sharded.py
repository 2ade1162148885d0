#!/usr/bin/env python3
"""Where a sweep of the sharded executor's boolean dense form goes on one
NVIDIA GPU at world size 1: the packed push kernel (K1) at the row counts
one data shard hands it, and the executor's Fact-1 reduction.

    python3 tools/probe_sharded.py

The state is ``chip_smoke.py``'s rmat16 (``rmat(16, 16,
directed=False, seed=1)``, 1,024 sources of seed 1) after 2 sweeps of
the pinned pull.  K1 runs on the first S rows for S = 128 ... 1,024 with
the prepared live-word index, once as one call and once as S / 128 calls
of 128 rows (the engines' tile), each held bit-identical to the other;
prints CUDA-event milliseconds and the device microseconds per kernel
that ``torch.profiler`` reads.  Then NCCL at world size 1 on a (1, 1)
``(data, model)`` mesh: the host seconds of the executor's ``converged``
reduction (one all-reduce over each mesh axis and one ``.item()``) against
``new.any()`` alone; and on grid256 (``grid2d(256, 256)``, 128 sources of
seed 1, 498 sweeps) the pinned push of the engine against the sharded
dense form, both after a warm-up run, with the ops that take the most
host time in one sharded run (``torch.profiler``).  One JSON line per
measurement, after the card's name and power limit.  Needs CUDA; builds
the kernels from ``src``.
"""
from __future__ import annotations

import datetime
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import SEED, cuda_ms, nvidia_smi  # noqa: E402

ROWS = (128, 256, 512, 1024)
TILE = 128


def profile_kernels(torch, fn, reps: int) -> dict:
    """Device microseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t and "_kernel" in ev.key:
            out[ev.key] = t / reps
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_sharded: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    import repro_torch
    from repro_torch.core.distributed import (ShardedConfig, _Mesh,
                                              prepare_sharded, sharded_apsp)
    from repro_torch.core.engine import (EngineConfig, apsp_engine_blocks,
                                         prepare_graph)
    from repro_torch.core.frontier import pack_bits
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import bovm
    from repro_torch.launch.mesh import make_mesh

    print(nvidia_smi(), flush=True)
    g = gen.rmat(16, 16, directed=False, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    srcs = np.sort(rng.choice(g.n_nodes, 1024, replace=False)) \
        .astype(np.int32)
    pg = prepare_graph(g, device="cuda")
    at, idx = pg.adj_pull, pg.adj_pull_index
    _, _, st = next(apsp_engine_blocks(pg, srcs, config=EngineConfig(
        mode="pull", use_kernel=True, max_steps=2, source_batch=1024)))
    f, d = st.frontier.contiguous(), st.dist.contiguous()
    fp_all = pack_bits(f != 0)
    words = at.shape[1]
    wk = 4 if words % 4 == 0 else 1

    def k1(fp, dd):
        return bovm.packed_push_sweep(fp, at, dd, 3, bs=min(
            fp.shape[0], 128), wk=wk, index=idx)

    for s in ROWS:
        fp, dd = fp_all[:s].contiguous(), d[:s].contiguous()
        tiles = [(fp[i: i + TILE].contiguous(), dd[i: i + TILE].contiguous())
                 for i in range(0, s, TILE)]
        one = k1(fp, dd)
        tiled = [k1(*t) for t in tiles]
        same = all(torch.equal(one[k], torch.cat([t[k] for t in tiled]))
                   for k in (0, 1))
        if not same:
            raise AssertionError(f"S={s}: one call differs from the tiles")
        print(json.dumps(dict(
            what="k1_rows", rows=s, one_call_ms=cuda_ms(torch, lambda: k1(
                fp, dd), 5),
            tiled_ms=cuda_ms(torch, lambda: [k1(*t) for t in tiles], 5),
            one_call_device_us=profile_kernels(torch, lambda: k1(fp, dd), 3),
            tile_device_us=profile_kernels(torch, lambda: k1(*tiles[0]), 3),
            pack_bits_ms=cuda_ms(torch, lambda: pack_bits(f[:s] != 0), 5),
            equal=True)), flush=True)

    store = tempfile.mkdtemp(prefix="probe_sharded_")
    dist.init_process_group(
        "nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        comm_mesh = make_mesh((1, 1), ("data", "model"))
        comm = _Mesh(comm_mesh)
        new = f[:TILE]

        def converged():
            flag = new.any().to(torch.int32).reshape(1)
            return int(comm.reduce_all(flag, dist.ReduceOp.SUM)) == 0

        def plain():
            return not bool(new.any())

        out = {}
        for name, fn in (("converged", converged), ("new_any", plain)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            out[f"{name}_ms"] = (time.perf_counter() - t0) / 200 * 1e3
        print(json.dumps(dict(what="fact1", **out)), flush=True)
        grid = gen.grid2d(256, 256, device="cuda")
        gsrc = np.sort(np.random.default_rng(SEED).choice(
            grid.n_nodes, 128, replace=False)).astype(np.int32)
        h = repro_torch.prepare(grid, mode="push")
        ops = prepare_sharded(grid, comm_mesh, config=ShardedConfig(),
                              dense_op=h.prepared())
        runs = {"engine_push": lambda: h.apsp(gsrc),
                "sharded_dense": lambda: sharded_apsp(ops, gsrc)}
        out = {}
        for name, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            out[f"{name}_s"] = time.perf_counter() - t0
            out[f"{name}_sweeps"] = res.sweeps
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sharded_apsp(ops, gsrc)
            torch.cuda.synchronize()
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        out["sharded_top_host_ops"] = [
            [e.key[:60], e.count, e.self_cpu_time_total,
             getattr(e, "device_time_total", 0.0)] for e in top[:15]]
        print(json.dumps(dict(what="grid256", **out)), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

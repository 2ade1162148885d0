#!/usr/bin/env python3
"""Run the PyTorch port of DAWN end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch`` (into
``build/repro_torch/``), drives the boolean engine through
``repro_torch.prepare(graph).apsp(sources)`` on two graphs of 65,536
nodes made by the port's own generators, checks the distances against
scipy's BFS, and holds every kernel bit-identical to its plain PyTorch
version at full width.  One JSON line per phase; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero.  Without CUDA, or outside a checkout of the repository,
it exits non-zero at once.

Graphs:
  rmat16   Graph500 RMAT parameters (A=0.57, B=0.19, C=0.19, edge factor
           16), undirected, seed 1, cut to scale 16 so the dense packed
           operand (n_pad^2 / 8 = 539 MB) fits one card; 1,024 sources.
  grid256  256 x 256 4-connected grid, road-like (diameter 510); 128
           sources.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 1
N_CHECK = 16                 # sources checked against scipy per graph
# float32 running sum of degrees over <= ~1,000 per-sweep partial sums,
# each a tree reduction of < 2^24-exact terms: relative error stays
# below (1,000 + 24) * 2^-24 ~ 6.1e-5
EDGES_RTOL = 1e-4

# least time the card could take (H100 SXM data sheet, dense rates at the
# 700 W limit): HBM bytes/s, int8 tensor-core ops/s, and 32-bit word
# logic ops/s (the float32 instruction rate, 67 TFLOP/s counting an FMA
# as two operations)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
WORD_OPS_PER_S = 33.5e12

REPLACES = {
    "packed_push_sweep": "src/repro/kernels/bovm/kernel.py:249",
    "packed_pull_sweep": "src/repro/kernels/bovm/kernel.py:184",
    "fused_boolean_multisweep": "src/repro/kernels/bovm/kernel.py:343",
    "fused_sweep": "src/repro/kernels/bovm/kernel.py:116",
}


def emit(**fields):
    print(json.dumps(fields), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
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


def scipy_dist(g, sources) -> np.ndarray:
    from scipy.sparse.csgraph import shortest_path
    d = shortest_path(g.to_scipy(), unweighted=True, indices=sources)
    return np.where(np.isinf(d), -1, d).astype(np.int32)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch
    from repro_torch.core.engine import EngineConfig, apsp_engine_blocks
    from repro_torch.core.frontier import pack_bits
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import _build
    from repro_torch.kernels import bovm
    from repro_torch.kernels.bovm import ref as R

    smi = nvidia_smi()
    emit(phase="device", nvidia_smi=smi,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- build: one nvcc per source, all started together ------------------
    sources_cu = sorted((SRC / "repro_torch").rglob("csrc/*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources_cu)) as pool:
        built = list(pool.map(_build.build, sources_cu))
    emit(phase="build", seconds=time.perf_counter() - t0,
         sources=[str(s.relative_to(ROOT)) for s in sources_cu],
         libraries=[p.name for p in built])

    # -- graphs --------------------------------------------------------------
    t0 = time.perf_counter()
    graphs = {
        "rmat16": gen.rmat(16, 16, directed=False, seed=SEED,
                           device="cuda"),
        "grid256": gen.grid2d(256, 256, device="cuda"),
    }
    expect_edges = {"rmat16": 1_820_400, "grid256": 261_120}
    rng = np.random.default_rng(SEED)
    batch = {"rmat16": 1024, "grid256": 128}
    srcs = {name: np.sort(rng.choice(g.n_nodes, batch[name], replace=False))
            .astype(np.int32) for name, g in graphs.items()}
    for name, g in graphs.items():
        if g.n_edges != expect_edges[name]:
            raise AssertionError(f"{name}: {g.n_edges} edges, expected "
                                 f"{expect_edges[name]}")
    emit(phase="graphs", seconds=time.perf_counter() - t0,
         graphs={k: {"n_nodes": g.n_nodes, "n_edges": g.n_edges,
                     "n_pad": g.n_padded(), "sources": int(len(srcs[k]))}
                 for k, g in graphs.items()})

    # -- the main path: default, pinned push / pull, fused -------------------
    runs = {
        "default": {},
        "push": dict(mode="push", use_kernel=True),
        "pull": dict(mode="pull", use_kernel=True),
        "fused": dict(fused_steps=-1),
    }
    kernels = (bovm.packed_push_sweep, bovm.packed_pull_sweep,
               bovm.fused_boolean_multisweep, bovm.fused_sweep)
    bovm.reset_launches()
    results = {}
    for name, g in graphs.items():
        check = srcs[name][:: len(srcs[name]) // N_CHECK][:N_CHECK]
        want = scipy_dist(g, check)
        rows = np.searchsorted(srcs[name], check)
        for run, opts in runs.items():
            h = repro_torch.prepare(g, **opts)
            h.prepared().adj_pull                # operand build = set-up
            before = [k.launches for k in kernels]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = h.apsp(srcs[name])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = res.dist[torch.from_numpy(rows).cuda()].cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{name}/{run}: dist differs from "
                                     f"scipy BFS")
            if not torch.isfinite(res.edges_touched):
                raise AssertionError(f"{name}/{run}: edges_touched")
            results[(name, run)] = res
            deg = h.prepared().deg[: g.n_nodes].double()
            touched64 = float(((res.dist >= 0).double() * deg).sum())
            touched = float(res.edges_touched)
            if run != "fused" and abs(touched - touched64) > \
                    EDGES_RTOL * touched64:
                raise AssertionError(f"{name}/{run}: edges_touched "
                                     f"{touched} vs {touched64}")
            emit(phase="apsp", graph=name, run=run, options=opts,
                 seconds=wall, sweeps=res.sweeps,
                 direction_counts=res.direction_counts.tolist(),
                 edges_touched=touched, edges_touched_f64=touched64,
                 launches={k.__name__: k.launches - b
                           for k, b in zip(kernels, before)},
                 dist_checked_rows=int(len(check)))
        base = results[(name, "default")]
        for run in ("push", "pull", "fused"):
            if not torch.equal(results[(name, run)].dist, base.dist):
                raise AssertionError(f"{name}/{run}: dist differs from "
                                     f"the default run")
        per, fused = results[(name, "push")], results[(name, "fused")]
        if per.sweeps != fused.sweeps or not torch.equal(
                per.direction_counts, fused.direction_counts):
            raise AssertionError(f"{name}: fused accounting differs from "
                                 f"the per-sweep push")
    launches = {k.__name__: k.launches for k in kernels}
    emit(phase="main_path", launches=launches)
    for k in kernels[:3]:
        if launches[k.__name__] < 1:
            raise AssertionError(f"{k.__name__} never launched on the "
                                 f"main path")

    # -- each kernel against its plain version, full width -------------------
    pg = repro_torch.prepare(graphs["rmat16"]).prepared()
    at, n_pad = pg.adj_pull, pg.n_pad
    words = at.shape[1]
    mid_step = 2
    _, _, st = next(apsp_engine_blocks(pg, srcs["rmat16"][:128],
                                       config=EngineConfig(
                                           mode="pull", use_kernel=True,
                                           max_steps=mid_step)))
    f, d = st.frontier.contiguous(), st.dist.contiguous()
    s = f.shape[0]
    fp = pack_bits(f != 0)
    torch.cuda.synchronize()

    nz_at = (at != 0).to(torch.float32)       # (n_pad, W), exact counts
    sector = 8                                # words per 32 B DRAM sector

    def packed_need(fp_, d_, new_):
        """Operand bytes and word ops one packed sweep needs on this state.
        A pair (s, j) still unreached that misses must read every operand
        word of column j where frontier row s is active; one that hits
        needs a single word.  Bytes, in 32 B sectors: per column, the
        union of its missing rows' active sectors, or one sector if all
        its pending rows hit.  Ops (an AND and a test per word): one for
        a hitting pair; for a missing pair every word where both frontier
        row s and in-neighbour row j are non-zero."""
        unreached = d_ < 0
        hit = unreached & (new_ != 0)
        miss = (unreached & (new_ == 0)).to(torch.float32)
        act = fp_ != 0
        pad = -act.shape[1] % sector
        act_sec = torch.nn.functional.pad(act, (0, pad)).reshape(
            act.shape[0], -1, sector).any(dim=2).to(torch.float32)
        miss_sec = ((miss.t() @ act_sec) > 0).sum(dim=1)     # (n_pad,)
        sectors = torch.where(miss_sec > 0, miss_sec,
                              hit.any(dim=0).to(miss_sec.dtype))
        both = act.to(torch.float32) @ nz_at.t()             # (S, n_pad)
        ops = 2.0 * (float(hit.sum())
                     + float(both[miss > 0].double().sum()))
        return 4 * sector * int(sectors.sum()), ops

    def state_bytes(s_, n_):
        return s_ * n_ * (4 + 1 + 4)         # dist in, new + dist out

    lib_f = f.to(torch.float16)
    lib_adj = pg.adj.to(torch.float16)
    library_ms = cuda_ms(torch, lambda: torch.matmul(lib_f, lib_adj), 3)
    del lib_adj

    rows_out = []

    def record(name, kern, plain, outs_k, outs_p, bytes_, ops, rate,
               reps, lib):
        for a, b in zip(outs_k, outs_p):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"{name}: kernel differs from its "
                                     f"plain version")
        err = float((outs_k[1].double() - outs_p[1].double()).abs().max())
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        rows_out.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/bovm/csrc/bovm.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=err, ms=cuda_ms(torch, kern, reps),
            plain_ms=cuda_ms(torch, plain, 1),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib, match=True,
            shape=dict(s=s, n_pad=n_pad, words=words)))
        emit(phase="kernel", **rows_out[-1])

    step = mid_step + 1
    wk = 4 if words % 8 else 8
    io = s * words * 4 + state_bytes(s, n_pad)

    def k1():
        return bovm.packed_push_sweep(fp, at, d, step, bs=128, bn=128, wk=wk)

    def k1_plain():
        return R.packed_pull_ref(fp, at, d, step)

    out1 = k1_plain()
    need_bytes, need_ops = packed_need(fp, d, out1[0])
    record("packed_push_sweep", k1, k1_plain, k1(), out1,
           io + need_bytes, need_ops, WORD_OPS_PER_S, 5, library_ms)

    def k2():
        return bovm.packed_pull_sweep(fp, at, d, step, bs=8, bn=128, wk=wk)

    record("packed_pull_sweep", k2, k1_plain, k2(), out1,
           io + need_bytes, need_ops, WORD_OPS_PER_S, 5, library_ms)

    n_run = 4

    def k3():
        return bovm.fused_boolean_multisweep(f, at, d, mid_step, n_run,
                                             bs=128, max_sweeps=n_run)

    def k3_plain():
        return R.fused_boolean_multisweep_ref(f, at, d, mid_step, n_run)

    out3 = k3()
    # the sweeps the block needs on this state, one packed sweep each
    fp_t, d_t, b3, o3 = fp, d, 0, 0.0
    for t in range(n_run):
        new_t, d_next = R.packed_pull_ref(fp_t, at, d_t, mid_step + 1 + t)
        nb, no = packed_need(fp_t, d_t, new_t)
        b3, o3, d_t = b3 + nb, o3 + no, d_next
        if not bool(new_t.any()):
            break
        fp_t = pack_bits(new_t != 0)
    record("fused_boolean_multisweep", k3, k3_plain, out3, k3_plain(),
           io + b3, o3, WORD_OPS_PER_S, 3, None)

    adj = pg.adj
    bk = 128

    def k4():
        return bovm.fused_sweep(f, adj, d, step, bs=128, bn=128, bk=bk)

    def k4_plain():
        return R.sweep_ref(f, adj, d, step)

    # operand rows of the live k-blocks, in the 32-column sectors that
    # hold an unreached target
    f_occ = (f != 0).reshape(1, s, n_pad // bk, bk).any(dim=3).any(dim=1)
    live_k = int(f_occ.sum())
    open_cols = (d < 0).any(dim=0)
    unreached_cols = int(open_cols.sum())
    open_sectors = int(open_cols.reshape(-1, 32).any(dim=1).sum())
    k4_bytes = (s * n_pad + live_k * bk * open_sectors * 32
                + state_bytes(s, n_pad))
    k4_ops = 2.0 * s * live_k * bk * unreached_cols
    record("fused_sweep", k4, k4_plain, k4(), k4_plain(), k4_bytes, k4_ops,
           INT8_OPS_PER_S, 3, library_ms)
    # launches of the comparisons above do not count: report the main path's
    for row in rows_out:
        row["launches"] = launches[row["name"]]

    print(json.dumps({"kernels": rows_out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

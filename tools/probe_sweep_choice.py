#!/usr/bin/env python3
"""Time each boolean sweep form at states drawn from the benchmark's
``msbfs`` cells, beside what the dense-priced cost model picks there.

    python3 tools/probe_sweep_choice.py [--seed N]

For each (cell, sweeps) of ``STATES``, the cell's graph is made as
``bench/run.py`` makes it (its configuration's generator and
``graph_seed``, both directions of every tuple through
``repro_torch``'s loader), the first 128 keys the cell's traffic deals
for ``--seed`` run that many pinned-push sweeps (K1), and on the state
reached each form of ``core/sweep.py::boolean_forms`` on the kernel path
(K1, K2, the sparse form) is timed: ``time_sweep_forms`` (host clock
around 8 chained sweeps, median of 5) and CUDA events around one sweep
from the state itself (mean of ``REPS``).  Beside the times: the
state's occupancy stats, the live-word index's entry count, the
dense-priced model's costs and argmin (the JAX package's, which the
engine still runs off the card) and the host time of one per-sweep
choice.  One JSON line per state, after the card's name and power limit.
Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STATES = (("kron18.msbfs", (1, 3, 5)), ("rgg18.msbfs", (10, 100, 300)))
ROWS = 128
REPS = 20


def emit(**fields):
    print(json.dumps(fields), flush=True)


def cuda_ms(torch, fn, reps: int = REPS) -> float:
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


def probe_state(pg, sources, sweeps: int):
    """-> dict of the state after ``sweeps`` pinned-push sweeps from
    ``sources`` on ``pg``: stats, the forms' times and the model's costs
    and argmin."""
    import torch

    from repro_torch.core import engine
    from repro_torch.core import sweep as S

    cfg = engine.EngineConfig(source_batch=ROWS, mode="push",
                              use_kernel=True, max_steps=sweeps)
    _, _, st = next(engine.apsp_engine_blocks(pg, sources, config=cfg))
    f, d = st.frontier, st.dist
    stats = engine.frontier_stats(f, d, bs=min(ROWS, 128), bn=cfg.bn,
                                  bk=cfg.bk)
    index = pg.adj_pull_index
    live = index.words.numel()
    m_pad = pg.graph.m_pad
    kw = dict(n_pad=pg.n_pad, s=ROWS, m_pad=m_pad, cfg=cfg)
    dense = engine.sweep_costs(stats, **kw).tolist()
    forms = S.boolean_forms(None, pg.adj_pull, pg.graph.src, pg.graph.dst,
                            n_pad=pg.n_pad, s=ROWS, bn=cfg.bn, bk=cfg.bk,
                            use_kernel=True, index=index)
    chained = S.time_sweep_forms(forms, f, d)
    parent = torch.zeros((1,), dtype=torch.int32, device=f.device)
    one = [cuda_ms(torch, lambda form=form: form(f, d, parent, st.step + 1))
           for form in forms]

    def choose():
        s = engine.frontier_stats(f, d, bs=min(ROWS, 128), bn=cfg.bn,
                                  bk=cfg.bk)
        return engine.choose_direction(s, **kw)

    choose()
    samples = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        choose()
        samples.append(time.perf_counter() - t0)
    names = S.DIRECTION_NAMES
    return dict(
        step=st.step, done=st.done,
        frontier=int((f != 0).sum()), unreached=int((d < 0).sum()),
        live_tile_frac=float(stats.live_tile_frac),
        o_occ_frac=float(stats.o_occ_frac),
        live_words=live, m_pad=m_pad, n_pad=pg.n_pad,
        chained_ms=[1e3 * t for t in chained], one_sweep_ms=one,
        measured=names[min(range(3), key=lambda i: chained[i])],
        measured_one=names[min(range(3), key=lambda i: one[i])],
        cost_dense=dense,
        dense_pick=names[engine.choose_direction(stats, **kw)],
        choose_us=1e6 * sorted(samples)[REPS // 2])


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=5_800_000_300)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    from bench import driver, manifest, systems

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    dev = torch.device("cuda")
    man = manifest.load()
    for cell, steps in STATES:
        work = manifest.workload(man, cell)
        cfg = manifest.config(man, work["config"])
        src, dst, n = manifest.generator(cfg["generator"]).generate(
            cfg, cfg["graph_seed"], dev)
        loop = src == dst
        degree = torch.bincount(torch.cat([src[~loop], dst[~loop]]),
                                minlength=n).cpu()
        plan = driver.Plan(manifest.traffic(work["traffic"]), degree,
                           args.seed, cfg["graph_seed"])
        sources = plan.sources()[:ROWS]
        sut = systems.Program(src.cpu(), dst.cpu(), n, dev)
        del src, dst, loop
        pg = sut.handle.prepared()
        for sweeps in steps:
            emit(cell=cell, seed=args.seed, sweeps=sweeps,
                 **probe_state(pg, sources, sweeps))
        sut.close()
        del pg, sut
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

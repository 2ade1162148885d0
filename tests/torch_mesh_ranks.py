"""Worlds of gloo ranks for the CPU tests of the sharded executor
(suite ``executor``) and of the training substrate's mesh placement
(suite ``train``: ``shard_batch``, ``make_jitted_step``,
``make_cross_pod_psum``).

``start(suite, world, tmp_path)`` launches ``world`` subprocesses of this
file, one per rank, each of which joins a gloo process group through a
``file://`` store under ``tmp_path`` (no port to collide between test
workers), runs ``SUITES[suite](world, rank, out_dir)`` with one thread and
saves the returned arrays to ``<suite>-rank<r>.npz``.  The parent compares
them with the single-device engines, each case as a test of its own.

Every rank makes the same calls (the executor's SPMD contract); a rank
outside a smaller mesh skips that mesh's calls.  A rank that dies makes
the others fail within the group's 60 s timeout instead of hanging, and
``World.results`` kills whatever is still running at its own timeout.
Ranks import no JAX.

By hand, a world of N CPU ranks of your own program:
``python -m torch.distributed.run --nproc-per-node=N prog.py`` with
``init_process_group("gloo")`` and ``make_mesh(..., device="cpu")`` in
``prog.py``.
"""
from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
GROUP_TIMEOUT_S = 60          # a collective waits this long for a rank

RMAT = dict(scale=9, edge_factor=6, directed=False, seed=5)   # n = 512
N_SOURCES = 24
MESHES = {"1": ((1,), ("data",)), "8": ((8,), ("data",)),
          "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
SEMIRINGS = ("boolean", "tropical", "counting")
MODES = ("dense", "sparse", "auto")
PLANS = ((8, 2), (8, 1), (6, 2), (4, 2), (4, 4), (2, 1), (1, 1))


class World:
    """A launched world; ``results()`` waits for it."""

    def __init__(self, suite: str, procs, out: pathlib.Path, timeout: float):
        self.suite, self.procs, self.out = suite, procs, out
        self.deadline = time.monotonic() + timeout

    def results(self):
        """Each rank's arrays (a dict per rank); raises with the first
        failing rank's stderr if any rank failed or the world timed out."""
        errors = []
        for r, p in enumerate(self.procs):
            try:
                _, err = p.communicate(
                    timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in self.procs:
                    q.kill()
                _, err = p.communicate()
                errors.append(f"rank {r} timed out:\n{err[-3000:]}")
                continue
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}:\n"
                              f"{err[-3000:]}")
        if errors:
            raise AssertionError(f"{self.suite}: " + "\n".join(errors))
        out = []
        for r in range(len(self.procs)):
            with np.load(self.out / f"{self.suite}-rank{r}.npz") as z:
                out.append({k: z[k] for k in z.files})
        return out


def start(suite: str, world: int, tmp_path, *, timeout: float = 600.0
          ) -> World:
    out = pathlib.Path(tmp_path)
    store = out / f"{suite}-store"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(world), str(r), str(store),
         str(out)], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    return World(suite, procs, out, timeout)


# --------------------------------------------------------------------------
# rank side
# --------------------------------------------------------------------------

def _weights(g, seed: int, lo: float, hi: float) -> np.ndarray:
    return np.random.default_rng(seed).uniform(lo, hi, g.m_pad).astype(
        np.float32)


def _put(res: dict, key: str, r) -> None:
    """The fields of a sharded or engine result under ``key``."""
    res[f"{key}.dist"] = r.dist.cpu().numpy()
    res[f"{key}.sweeps"] = np.int64(r.sweeps)
    res[f"{key}.dirs"] = np.asarray(r.direction_counts.tolist(), np.int32)
    if getattr(r, "sigma", None) is not None:
        res[f"{key}.sigma"] = r.sigma.cpu().numpy()
    if getattr(r, "edges_touched", None) is not None:
        res[f"{key}.edges"] = np.float32(float(r.edges_touched))


def suite_executor(world: int, rank: int, out: pathlib.Path) -> dict:
    """Every case of ``tests/test_torch_distributed.py`` in one world of
    8 ranks (smaller meshes are subsets of it)."""
    import torch
    import torch.distributed as dist
    from repro_torch import SweepOptions, prepare
    from repro_torch.core.centrality import CentralityConfig, counting_apsp
    from repro_torch.core.distributed import (ShardedConfig, mesh_barrier,
                                              sharded_apsp)
    from repro_torch.core.jobs import run_sweep_job
    from repro_torch.graph import generators as gen
    from repro_torch.launch import mesh as M
    from repro_torch.serve import GraphQuery, GraphService
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import checkpoint as ckpt

    res = {}
    # every rank builds every mesh, in one order
    meshes = {name: M.make_mesh(shape, axes, device="cpu")
              for name, (shape, axes) in MESHES.items()}
    mesh22 = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    mesh11 = M.make_mesh((1, 1), ("data", "model"), device="cpu")
    small2 = M.make_mesh((2,), ("data",), device="cpu")

    def mine(mesh):
        return mesh.get_coordinate() is not None

    # -- the mesh helpers on plan_remesh's plans -----------------------------
    for alive, mp in PLANS:
        plan = FT.plan_remesh(alive, model_parallel=mp)
        m = M.mesh_from_plan(plan, device="cpu")
        key = f"plan.{alive}.{mp}"
        res[f"{key}.shape"] = np.asarray(m.mesh.shape, np.int64)
        res[f"{key}.names"] = np.asarray(m.mesh_dim_names)
        res[f"{key}.dp_axes"] = np.asarray(M.dp_axes(m) or ("",))
        res[f"{key}.dp_size"] = np.int64(M.dp_size(m))
        res[f"{key}.member"] = np.int64(mine(m))
    try:
        M.make_production_mesh(device="cpu")
        res["production_mesh_raised"] = np.int64(0)
    except ValueError:
        res["production_mesh_raised"] = np.int64(1)

    # -- every mesh x semiring x mode against the engines -------------------
    g = gen.rmat(RMAT["scale"], RMAT["edge_factor"],
                 directed=RMAT["directed"], seed=RMAT["seed"], device="cpu")
    w = _weights(g, 0, 0.5, 4.0)
    srcs = np.arange(N_SOURCES, dtype=np.int32)
    for name, mesh in meshes.items():
        if not mine(mesh):
            continue
        for sr in SEMIRINGS:
            for mode in MODES:
                r = sharded_apsp(g, srcs, mesh=mesh,
                                 weights=w if sr == "tropical" else None,
                                 config=ShardedConfig(semiring=sr,
                                                      mode=mode))
                _put(res, f"mesh.{name}.{sr}.{mode}", r)

    # -- a prepared graph's operand handed over at C == 1 (rank 0) ----------
    if mine(meshes["1"]):
        from repro_torch.core.engine import prepare_graph
        from repro_torch.core.distributed import prepare_sharded
        from repro_torch.core.weighted import prepare_weighted
        pg, pw = prepare_graph(g, device="cpu"), prepare_weighted(
            g, w, device="cpu")
        for sr in SEMIRINGS:
            ops = prepare_sharded(
                g, meshes["1"], weights=w if sr == "tropical" else None,
                config=ShardedConfig(semiring=sr),
                dense_op=pw if sr == "tropical" else pg)
            held = pw.wdense if sr == "tropical" else pg.adj
            res[f"handover.{sr}.same_tensor"] = np.int64(
                ops.dense_op is held)
            _put(res, f"handover.{sr}", sharded_apsp(ops, srcs))
        refused = 0
        for kw, err in (
                (dict(dense_op=pg.adj), TypeError),
                (dict(dense_op=prepare_graph(g, align=256, device="cpu")),
                 ValueError),
                (dict(dense_op=pg, config=ShardedConfig(mode="sparse")),
                 ValueError)):
            try:
                prepare_sharded(g, meshes["1"], **kw)
            except err:
                refused += 1
        res["handover.refused"] = np.int64(refused)

    # -- n = 237 on (2, 4): neither n nor 13 sources divide ------------------
    ger = gen.erdos_renyi(237, 3.0, seed=9, device="cpu")
    wer = _weights(ger, 1, 0.1, 5.0)
    for sr in SEMIRINGS:
        for mode in ("dense", "sparse"):
            r = sharded_apsp(ger, np.arange(13), mesh=meshes["2x4"],
                             weights=wer if sr == "tropical" else None,
                             config=ShardedConfig(semiring=sr, mode=mode))
            _put(res, f"ragged.{sr}.{mode}", r)

    # -- the kernel path on CPU ranks: the plain versions of K1, K5, K7 and
    # K9 on K-row blocks and partitioned lanes of a (2, 2) mesh ------------
    gk = gen.rmat(7, 4, directed=False, seed=3, device="cpu")      # n = 128
    wk = _weights(gk, 0, 0.5, 4.0)
    if mine(mesh22):
        for sr, mode in (("boolean", "dense"), ("counting", "dense"),
                         ("tropical", "dense"), ("tropical", "sparse")):
            r = sharded_apsp(gk, np.arange(8), mesh=mesh22,
                             weights=wk if sr == "tropical" else None,
                             config=ShardedConfig(semiring=sr, mode=mode,
                                                  use_kernel=True))
            _put(res, f"kernel.{sr}.{mode}", r)

    # -- the frontier packer on a (2, 2) mesh: the OR combine's words (the
    # whole n_pad) and, on the kernel path, K1's K block (n_pad / 2),
    # counted through the boolean set's pack -------------------------------
    import dataclasses

    from repro_torch.kernels import registry
    if mine(mesh22):
        ks = registry.get("boolean")
        for mode, use_kernel in (("dense", True), ("sparse", False)):
            widths = []

            def counted(x):
                widths.append(x.shape[-1])
                return ks.pack(x)

            registry.register(dataclasses.replace(ks, pack=counted))
            try:
                r = sharded_apsp(gk, np.arange(8), mesh=mesh22,
                                 config=ShardedConfig(mode=mode,
                                                      use_kernel=use_kernel))
            finally:
                registry.register(ks)
            n_pad = max(widths)
            res[f"packs.{mode}"] = np.asarray(
                [widths.count(n_pad // 2), widths.count(n_pad), r.sweeps],
                np.int64)

    # -- the mesh's spans and counters (repro_torch.trace) ------------------
    # every call above ran with the profiler off: nothing in the window
    from repro_torch import trace
    from repro_torch.core.distributed import prepare_sharded
    window = trace.snapshot()["window"]
    res["trace.off_window_empty"] = np.int64(
        window == {"spans": {}, "counters": {}})
    mesh_names = ("dawn.mesh.combine", "dawn.mesh.gather",
                  "dawn.mesh.reduce")
    for key, mesh, gt, kw in (
            [(f"trace.{sr}", meshes["2x4"], g, dict(semiring=sr))
             for sr in SEMIRINGS]
            + ([("trace.packed", mesh22, gk,
                 dict(semiring="boolean", use_kernel=True))]
               if mine(mesh22) else [])):
        trace.reset()
        tropical = kw["semiring"] == "tropical"
        ops = prepare_sharded(
            gt, mesh, weights=_weights(gt, 0, 0.5, 4.0) if tropical else None,
            config=ShardedConfig(mode="dense", **kw))
        setup = trace.snapshot()["setup"]
        res[f"{key}.block_n"] = np.int64(
            setup["spans"].get("dawn.mesh.block", {}).get("n", 0))
        res[f"{key}.block_bytes"] = np.int64(
            setup["gauges"].get("dawn.mesh.block_bytes", -1))
        res[f"{key}.block_held"] = np.int64(
            ops.dense_op.numel() * ops.dense_op.element_size())
        res[f"{key}.block_shape"] = np.asarray(ops.dense_op.shape, np.int64)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            r = sharded_apsp(ops, srcs)
        names = {e.name for e in prof.events()}
        res[f"{key}.in_events"] = np.int64(all(m in names
                                               for m in mesh_names))
        window = trace.snapshot()["window"]
        for m in mesh_names:
            res[f"{key}.{m.rpartition('.')[2]}"] = np.int64(
                window["spans"].get(m, {}).get("n", 0))
        res[f"{key}.gather_bytes"] = np.int64(
            window["counters"].get("dawn.mesh.gather_bytes", 0))
        res[f"{key}.counted_sweeps"] = np.int64(
            window["counters"].get("dawn.sweeps", 0))
        _put(res, key, r)
    trace.reset()

    # -- the facade: prepare(g).apsp(mesh=), its cache and centrality -------
    h = prepare(g, weights=w, device="cpu")
    for sr in SEMIRINGS:
        r = h.apsp(srcs, semiring=sr, mesh=meshes["2x4"])
        ops = h._sharded[sr]
        r2 = h.apsp(srcs[:8], semiring=sr, mesh=meshes["2x4"])
        _put(res, f"facade.{sr}", r)
        res[f"facade.{sr}.cached"] = np.int64(
            h._sharded[sr] is ops and torch.equal(r2.dist, r.dist[:8]))
    c = h.centrality(srcs, mesh=meshes["8"])
    for f in ("closeness", "harmonic", "eccentricity", "betweenness"):
        res[f"centrality.{f}"] = np.asarray(getattr(c, f))
    for f in ("radius", "diameter", "sweeps", "sigma_checksum"):
        res[f"centrality.{f}"] = np.asarray(getattr(c, f))

    # -- GraphService on a (1, 1) mesh (rank 0) ------------------------------
    if mine(mesh11):
        gs = gen.watts_strogatz(96, 6, 0.1, seed=3, device="cpu")
        ws = _weights(gs, 0, 0.5, 3.0)
        svc = GraphService(gs, weights=ws, max_batch=16, mesh=mesh11,
                           sharded_threshold=4, device="cpu")
        for i in range(5):
            svc.submit(GraphQuery(qid=i, source=i,
                                  target=None if i % 2 else 90))
        for i in range(5, 10):
            svc.submit(GraphQuery(qid=i, source=i, weighted=True,
                                  target=None if i % 2 else 90))
        served = svc.flush()
        res["serve.flushes"] = np.int64(svc.sharded_flushes)
        res["serve.by"] = np.asarray([q.served_by for q in served])
        for q in served:
            key = f"serve.q{q.qid}"
            if q.target is None:
                res[key] = np.asarray(q.dist)
            else:
                res[key] = np.float64(q.cost if q.weighted else q.hops)
        svc2 = GraphService(gs, max_batch=16, mesh=mesh11,
                            sharded_threshold=8, device="cpu")
        for i in range(3):
            svc2.submit(GraphQuery(qid=i, source=i))
        svc2.flush()
        res["serve.small_flushes"] = np.int64(svc2.sharded_flushes)

    # -- the elastic job: counting, killed on (4, 2), resumed on (2, 2) -----
    class Boom(RuntimeError):
        pass

    def kill_at(chunk):
        def on_chunk(k):
            if k == chunk:
                raise Boom()
        return on_chunk

    gj = gen.rmat(8, 6, directed=False, seed=5, device="cpu")      # n = 256
    jsrcs = np.arange(32, dtype=np.int32)
    opts = SweepOptions(source_batch=8, mode="dense")
    full = run_sweep_job(gj, jsrcs, workload="counting", mesh=meshes["4x2"],
                         options=opts, chunk_size=8)
    single = counting_apsp(gj, jsrcs, config=opts.to(CentralityConfig,
                                                     lenient=True))
    res["job.single_equal"] = np.int64(
        np.array_equal(full.dist, single.dist.numpy())
        and np.array_equal(full.sigma, single.sigma.numpy())
        and full.sweeps == single.sweeps)
    d = out / "job-counting"
    try:
        run_sweep_job(gj, jsrcs, workload="counting", mesh=meshes["4x2"],
                      options=opts, chunk_size=8, checkpoint_dir=str(d),
                      on_chunk=kill_at(1))
    except Boom:
        pass
    # a virtual 2-host world: host 1 stops beating -> dead -> a new plan
    t = [0.0]
    mon = FT.HeartbeatMonitor(2, interval_s=10.0, dead_after=3,
                              clock=lambda: t[0])
    for step in range(1, 10):
        t[0] = 10.0 * step
        mon.beat(0)
        if step < 2:
            mon.beat(1)
    dead = mon.sweep()
    plan = FT.plan_remesh(len(mon.alive_hosts) * 4, model_parallel=2,
                          restore_step=None, dropped_hosts=tuple(dead))
    small = M.mesh_from_plan(plan, device="cpu")
    res["job.dead"] = np.asarray(dead, np.int64)
    res["job.small_shape"] = np.asarray(small.mesh.shape, np.int64)
    if mine(small):
        got = run_sweep_job(gj, jsrcs, workload="counting", mesh=small,
                            options=opts, chunk_size=8,
                            checkpoint_dir=str(d))
        for key, jr in (("job.full", full), ("job.resumed", got)):
            res[f"{key}.dist"] = jr.dist
            res[f"{key}.sigma"] = jr.sigma
            res[f"{key}.counters"] = np.asarray(
                [jr.sweeps, jr.edges_touched, jr.chunks_total,
                 jr.chunks_computed, jr.chunks_restored,
                 -1 if jr.restored_step is None else jr.restored_step],
                np.float64)
            res[f"{key}.dirs"] = jr.direction_counts
        # restore(shardings=): replicated onto this rank's device
        like = {"a": np.zeros(3, np.int32)}
        if rank == 0:
            ckpt.save(str(out / "restore"), 1, {"a": np.arange(3, dtype=
                                                              np.int32)})
        mesh_barrier(small)
        tree, _ = ckpt.restore(str(out / "restore"), 1, like,
                               shardings={"a": small})
        res["restore.device"] = np.asarray(str(tree["a"].device))
        res["restore.a"] = tree["a"].numpy()

    # -- the boolean job: (2, 4) -> (2,), and edges_touched across shapes ----
    gb = gen.erdos_renyi(237, 3.0, seed=9, device="cpu")
    bsrcs = np.arange(24, dtype=np.int32)
    a = sharded_apsp(gb, bsrcs, mesh=meshes["2x4"],
                     config=ShardedConfig(mode="dense"))
    bfull = run_sweep_job(gb, bsrcs, workload="boolean",
                          mesh=meshes["2x4"], options=opts, chunk_size=8)
    db = out / "job-boolean"
    try:
        run_sweep_job(gb, bsrcs, workload="boolean", mesh=meshes["2x4"],
                      options=opts, chunk_size=8, checkpoint_dir=str(db),
                      on_chunk=kill_at(0))
    except Boom:
        pass
    if mine(small2):
        b = sharded_apsp(gb, bsrcs, mesh=small2,
                         config=ShardedConfig(mode="dense"))
        bres = run_sweep_job(gb, bsrcs, workload="boolean", mesh=small2,
                             options=opts, chunk_size=8,
                             checkpoint_dir=str(db))
        res["bjob.edges"] = np.asarray([float(a.edges_touched),
                                        float(b.edges_touched)])
        for key, jr in (("bjob.full", bfull), ("bjob.resumed", bres)):
            res[f"{key}.dist"] = jr.dist
            res[f"{key}.counters"] = np.asarray(
                [jr.sweeps, jr.edges_touched, jr.chunks_restored],
                np.float64)
            res[f"{key}.dirs"] = jr.direction_counts
    dist.barrier()
    return res


# -- the training substrate (suite "train", 4 ranks) ------------------------

LM = dict(vocab=32, d=8, layers=2, batch=8, seq=16)
TRAIN_STEPS = 3


def lm_params(seed: int = 0) -> dict:
    """The small LM's params as float32 numpy: an embedding, a stacked
    (layers, d, d) leaf, an output matrix and a bias."""
    rng = np.random.default_rng(seed)
    v, d, n_l = LM["vocab"], LM["d"], LM["layers"]
    return {"emb": (rng.normal(size=(v, d)) * 0.5).astype(np.float32),
            "stack": (rng.normal(size=(n_l, d, d)) / np.sqrt(d))
            .astype(np.float32),
            "out": (rng.normal(size=(d, v)) * 0.5).astype(np.float32),
            "bias": np.zeros(v, np.float32)}


def lm_loss(params, batch):
    """Mean next-token cross entropy of a residual tanh stack (torch)."""
    import torch
    h = params["emb"][batch["tokens"].long()]
    for i in range(params["stack"].shape[0]):
        h = torch.tanh(h @ params["stack"][i]) + h
    logits = h @ params["out"] + params["bias"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, batch["labels"].long()[..., None]).mean()


def psum_input(rank: int) -> np.ndarray:
    return (np.random.default_rng(rank).normal(size=(5, 7)) * (rank + 1)) \
        .astype(np.float32)


def train_specs():
    """(param_specs, batch_specs) of the jitted step on a (2, 2)
    ``(data, model)`` mesh."""
    from repro_torch.launch.mesh import PartitionSpec as P
    return ({"emb": P("data", None), "stack": P(None, "data", "model"),
             "out": P(None, "model"), "bias": P()},
            {"tokens": P("data"), "labels": P(("data", "model"))})


def suite_train(world: int, rank: int, out: pathlib.Path) -> dict:
    """``shard_batch``, ``make_jitted_step`` (AdamW and Adafactor) and
    ``make_cross_pod_psum`` (int8 and none) on meshes of 4 ranks."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.data import pipeline as PL
    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh import PartitionSpec as P
    from repro_torch.train import compression as CP
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import make_jitted_step

    res = {}
    dm = M.make_mesh((2, 2), ("data", "model"), device="cpu")
    pm = M.make_mesh((2, 2), ("pod", "data"), device="cpu")
    res["coord"] = np.asarray(dm.get_coordinate(), np.int64)

    # -- shard_batch: local shards and the whole tensors ---------------------
    batch = lm_batch(0, global_batch=LM["batch"], seq_len=LM["seq"],
                     vocab=LM["vocab"])
    specs = {"tokens": P("data"), "labels": P(None, "model")}
    got = PL.shard_batch(dm, batch, specs)
    for k, v in got.items():
        assert isinstance(v, DTensor)
        res[f"shard.{k}.local"] = v.to_local().numpy()
        res[f"shard.{k}.full"] = v.full_tensor().numpy()
    both = PL.shard_batch(dm, {"x": np.arange(16, dtype=np.int32)},
                          {"x": P(("data", "model"))})["x"]
    res["shard.both.local"] = both.to_local().numpy()
    raised = []
    for bad in (P("pod"), P("data", "data"), P(("model", "data")),
                P(None, None, "data")):
        try:
            PL.shard_batch(dm, {"t": batch["tokens"]}, {"t": bad})
            raised.append(0)
        except ValueError:
            raised.append(1)
    res["shard.raised"] = np.asarray(raised, np.int64)

    # -- make_jitted_step: AdamW and Adafactor over TRAIN_STEPS batches ------
    param_specs, batch_specs = train_specs()
    for name, opt in (("adamw", O.adamw(
            peak_lr=1e-2, schedule=O.cosine_schedule(1e-2, warmup=1,
                                                     total=10))),
                      ("adafactor", O.adafactor(peak_lr=1e-2))):
        step, state_specs = make_jitted_step(
            lm_loss, opt, dm, param_specs, batch_specs=batch_specs,
            accum=2)
        params = {k: torch.from_numpy(v) for k, v in lm_params().items()}
        state = opt.init(params)
        for i in range(TRAIN_STEPS):
            b = PL.shard_batch(dm, lm_batch(
                i, global_batch=LM["batch"], seq_len=LM["seq"],
                vocab=LM["vocab"]), batch_specs)
            params, state, metrics = step(params, state, b)
            res[f"jit.{name}.loss.{i}"] = metrics["loss"].numpy()
        for k, v in params.items():
            assert isinstance(v, DTensor)
            res[f"jit.{name}.param.{k}"] = v.full_tensor().numpy()
            res[f"jit.{name}.local.{k}"] = v.to_local().numpy()
        if name == "adafactor":
            st = state["stats"]["stack"]
            res["jit.adafactor.vr.local"] = st["vr"].to_local().numpy()
            res["jit.adafactor.vr.placements"] = np.asarray(
                [str(p) for p in st["vr"].placements])
        # an input laid out otherwise is refused
        wrong = dict(params, emb=PL.place(dm, params["emb"].full_tensor(),
                                          P(None, "model")))
        try:
            step(wrong, state, b)
            res[f"jit.{name}.wrong_layout_raised"] = np.int64(0)
        except ValueError:
            res[f"jit.{name}.wrong_layout_raised"] = np.int64(1)

    # -- make_cross_pod_psum over the (pod, data) mesh's pod groups ----------
    g = torch.from_numpy(psum_input(rank))
    res["psum.int8"] = CP.make_cross_pod_psum("int8", mesh=pm)(g).numpy()
    res["psum.none"] = CP.make_cross_pod_psum("none", mesh=pm)(g).numpy()
    try:
        CP.make_cross_pod_psum("int8", mesh=dm)
        res["psum.no_pod_raised"] = np.int64(0)
    except ValueError:
        res["psum.no_pod_raised"] = np.int64(1)
    dist.barrier()
    return res


SUITES = {"executor": suite_executor, "train": suite_train}


def _rank_main(suite: str, world: int, rank: int, store: str,
               out: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        res = SUITES[suite](world, rank, pathlib.Path(out))
        np.savez(pathlib.Path(out) / f"{suite}-rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
               sys.argv[5])

"""The port's resumable sweep jobs (``repro_torch/core/jobs.py``) against
the JAX package's ``run_sweep_job``: every ``JobResult`` field equal for
the boolean, counting and tropical workloads, the same manifests (job
fingerprint included) and the same checkpoint bytes, resume across the
packages; the fault-injection cases of ``tests/test_jobs.py`` (kill and
resume, a kill inside the interval, a corrupt checkpoint, a different
job, a finished job, the facade, a mutated dynamic graph) on the port;
and the hard fields of ``bench_resume --quick``.

A form is pinned in most runs (``mode=``): the default CPU regime picks
the direction by wall clock, so its ``direction_counts`` are not
reproducible across invocations.  Under a ``TuningPlan`` (``tuning=``)
``mode="auto"`` is reproducible: those runs, and a kill and resume across
the packages, are compared with their ``direction_counts``.  Everything
is compared exactly.
"""
import filecmp
import json
import os
import pathlib
import shutil
import tempfile

import numpy as np
import pytest
import torch

from benchmarks.bench_resume import _kill_after as bench_kill_after
from repro.core.autotune import build_plan as jbuild_plan
from repro.core.jobs import run_sweep_job as jrun
from repro.core.options import SweepOptions as JSweepOptions
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSRGraph
from repro.graph.dynamic import DynamicCSRGraph as JDynamic
import repro_torch
from repro_torch.convert import csr_from_arrays
from repro_torch.core.autotune import TuningPlan
from repro_torch.core.centrality import CentralityConfig, counting_apsp
from repro_torch.core.engine import EngineConfig, apsp_engine
from repro_torch.core.jobs import (JobMismatchError, JobResult,
                                   run_sweep_job)
from repro_torch.core.options import SweepOptions
from repro_torch.graph.dynamic import DynamicCSRGraph
from repro_torch.train import checkpoint as C

from oracles import adversarial_families, bfs_dists

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
OPTS = SweepOptions(source_batch=8, mode="sparse")
J_OPTS = JSweepOptions(source_batch=8, mode="sparse")
FIELDS = ("sweeps", "edges_touched", "chunks_total", "chunks_computed",
          "chunks_restored", "checkpoints_written", "restored_step",
          "corrupt_skipped")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Preempt(RuntimeError):
    """Injected kill."""


def _kill_after(chunk_idx):
    def on_chunk(k):
        if k == chunk_idx:
            raise _Preempt(f"killed after chunk {k}")
    return on_chunk


def _port(jg):
    return csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                           n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                           m_pad=jg.m_pad, device="cpu")


def _graphs():
    keep = ("star_in", "path", "two_components", "random_ragged")
    out = {}
    for name, src, dst, n in adversarial_families(seed=0):
        if name in keep:
            jg = JCSRGraph.from_edges(src, dst, n)
            out[name] = (jg, _port(jg))
    return out


GRAPHS = _graphs()


def _weights(g, workload, seed=3):
    if workload != "tropical":
        return None
    return np.random.default_rng(seed).uniform(0.5, 4.0, g.m_pad) \
        .astype(np.float32)


def _assert_equal(a: JobResult, b, *, counters=True):
    """``b`` may be the JAX package's JobResult (arrays as numpy)."""
    assert isinstance(a.dist, np.ndarray)
    assert a.dist.dtype == np.asarray(b.dist).dtype
    np.testing.assert_array_equal(a.dist, np.asarray(b.dist))
    assert (a.sigma is None) == (b.sigma is None)
    if a.sigma is not None:
        np.testing.assert_array_equal(a.sigma, np.asarray(b.sigma))
    np.testing.assert_array_equal(a.direction_counts,
                                  np.asarray(b.direction_counts))
    assert a.direction_counts.dtype == np.int32
    fields = FIELDS if counters else FIELDS[:3]
    for f in fields:
        assert getattr(a, f) == getattr(b, f), f
    assert isinstance(a.sweeps, int) and isinstance(a.edges_touched, float)


# -- the port against the JAX package ---------------------------------------

WORKLOAD_MODES = [("boolean", "sparse"), ("boolean", "push"),
                  ("boolean", "pull"), ("counting", "sparse"),
                  ("counting", "push"), ("tropical", "sparse"),
                  ("tropical", "dense")]


@pytest.mark.parametrize("workload,mode", WORKLOAD_MODES)
def test_job_matches_jax(workload, mode):
    for name, (jg, tg) in GRAPHS.items():
        w = _weights(jg, workload)
        srcs = np.arange(min(20, jg.n_nodes), dtype=np.int32)[::-1]
        kw = dict(workload=workload, weights=w, chunk_size=6)
        want = jrun(jg, srcs, options=JSweepOptions(source_batch=8,
                                                    mode=mode), **kw)
        got = run_sweep_job(tg, srcs, options=SweepOptions(source_batch=8,
                                                           mode=mode),
                            device="cpu", **kw)
        _assert_equal(got, want)


@pytest.mark.parametrize("workload", ["boolean", "tropical", "counting"])
def test_manifests_and_bytes_match_jax_and_resume_across(workload):
    """The same job writes the same checkpoint directory in both packages
    (manifests with the job fingerprint, and leaf bytes), and each
    package resumes from a directory the other one left behind."""
    jg, tg = GRAPHS["random_ragged"]
    w = _weights(jg, workload)
    srcs = np.arange(32, dtype=np.int32)
    kw = dict(workload=workload, weights=w, chunk_size=8, keep=10)
    with tempfile.TemporaryDirectory() as d:
        jd, td = os.path.join(d, "jax"), os.path.join(d, "torch")
        full_j = jrun(jg, srcs, options=J_OPTS, checkpoint_dir=jd, **kw)
        full_t = run_sweep_job(tg, srcs, options=OPTS, checkpoint_dir=td,
                               device="cpu", **kw)
        _assert_equal(full_t, full_j)
        assert C.all_steps(td) == C.all_steps(jd) == [1, 2, 3, 4]
        for step in C.all_steps(td):
            a, b = (os.path.join(x, f"step_{step:09d}") for x in (jd, td))
            assert sorted(os.listdir(a)) == sorted(os.listdir(b))
            match, mismatch, errors = filecmp.cmpfiles(
                a, b, os.listdir(a), shallow=False)
            assert not mismatch and not errors, mismatch
            man = C.read_manifest(td, step)
            assert man["meta"]["workload"] == workload
            assert man["meta"]["chunks_total"] == 4
        # a run JAX killed, resumed by the port, and the reverse
        for first, second, opts in ((jrun, run_sweep_job, OPTS),
                                    (run_sweep_job, jrun, J_OPTS)):
            kd = os.path.join(d, f"killed-{first.__module__}")
            fkw = dict(device="cpu") if first is run_sweep_job else {}
            skw = dict(device="cpu") if second is run_sweep_job else {}
            with pytest.raises(_Preempt):
                first(jg if first is jrun else tg, srcs,
                      options=J_OPTS if first is jrun else OPTS,
                      checkpoint_dir=kd, on_chunk=_kill_after(1), **kw,
                      **fkw)
            res = second(tg if second is run_sweep_job else jg, srcs,
                         options=opts, checkpoint_dir=kd, **kw, **skw)
            assert res.chunks_restored == 2 and res.restored_step == 2
            assert res.chunks_computed == 2
            np.testing.assert_array_equal(np.asarray(res.dist),
                                          full_t.dist)


# -- mode="auto" under a plan (tests/test_jobs.py's options) ----------------

# one static plan, built by the JAX package, serves every family: the
# direction pin uses per-call (s, n_pad, m_pad) and tiles clamp per graph
J_PLAN = jbuild_plan(GRAPHS["random_ragged"][0], use_hlo=False)
AUTO = SweepOptions(source_batch=8, mode="auto",
                    tuning=TuningPlan.from_dict(J_PLAN.to_dict()))
J_AUTO = JSweepOptions(source_batch=8, mode="auto", tuning=J_PLAN)


@pytest.mark.parametrize("workload", ["boolean", "tropical", "counting"])
def test_auto_job_with_plan_matches_jax(workload):
    """Every field, direction_counts included, equal to the JAX package's
    run under the same plan, and to the port's own second run."""
    for name, (jg, tg) in GRAPHS.items():
        w = _weights(jg, workload)
        srcs = np.arange(min(20, jg.n_nodes), dtype=np.int32)[::-1]
        kw = dict(workload=workload, weights=w, chunk_size=6)
        want = jrun(jg, srcs, options=J_AUTO, **kw)
        got = run_sweep_job(tg, srcs, options=AUTO, device="cpu", **kw)
        again = run_sweep_job(tg, srcs, options=AUTO, device="cpu", **kw)
        _assert_equal(got, want)
        _assert_equal(again, got)
        assert got.direction_counts.sum() > 0, name


@pytest.mark.parametrize("workload", ["boolean", "tropical", "counting"])
def test_auto_job_with_plan_resumes_across_packages(workload):
    """A run killed by one package and resumed by the other equals the
    uninterrupted run, direction_counts included."""
    jg, tg = GRAPHS["random_ragged"]
    w = _weights(jg, workload)
    srcs = np.arange(32, dtype=np.int32)
    kw = dict(workload=workload, weights=w, chunk_size=8)
    full = jrun(jg, srcs, options=J_AUTO, **kw)
    port = {"graph": tg, "options": AUTO, "device": "cpu"}
    jax_ = {"graph": jg, "options": J_AUTO}
    with tempfile.TemporaryDirectory() as d:
        for (first, fa), (second, sa) in (((jrun, jax_),
                                           (run_sweep_job, port)),
                                          ((run_sweep_job, port),
                                           (jrun, jax_))):
            kd = os.path.join(d, first.__module__)
            fa, sa = dict(fa), dict(sa)
            with pytest.raises(_Preempt):
                first(fa.pop("graph"), srcs, checkpoint_dir=kd,
                      on_chunk=_kill_after(1), **kw, **fa)
            res = second(sa.pop("graph"), srcs, checkpoint_dir=kd, **kw,
                         **sa)
            assert res.chunks_restored == 2 and res.chunks_computed == 2
            np.testing.assert_array_equal(np.asarray(res.dist), full.dist)
            if full.sigma is not None:
                np.testing.assert_array_equal(np.asarray(res.sigma),
                                              full.sigma)
            np.testing.assert_array_equal(np.asarray(res.direction_counts),
                                          full.direction_counts)
            assert res.sweeps == full.sweeps
            assert res.edges_touched == full.edges_touched


# -- the fault-injection cases ---------------------------------------------

def test_job_matches_engine_boolean_and_counting():
    _, g = GRAPHS["random_ragged"]
    srcs = np.arange(24, dtype=np.int32)
    job = run_sweep_job(g, srcs, workload="boolean", options=OPTS,
                        chunk_size=8, device="cpu")
    eng = apsp_engine(g, srcs, config=OPTS.to(EngineConfig, lenient=True))
    np.testing.assert_array_equal(job.dist, eng.dist.numpy())
    np.testing.assert_array_equal(job.dist, bfs_dists(
        GRAPHS["random_ragged"][0], srcs))
    assert job.sweeps == eng.sweeps
    np.testing.assert_array_equal(job.direction_counts,
                                  eng.direction_counts.numpy())
    assert job.edges_touched == float(eng.edges_touched)
    assert (job.chunks_total, job.chunks_computed,
            job.chunks_restored) == (3, 3, 0)
    jc = run_sweep_job(g, srcs, workload="counting", options=OPTS,
                       chunk_size=8, device="cpu")
    ec = counting_apsp(g, srcs, config=OPTS.to(CentralityConfig,
                                               lenient=True))
    np.testing.assert_array_equal(jc.dist, ec.dist.numpy())
    np.testing.assert_array_equal(jc.sigma, ec.sigma.numpy())
    assert jc.sweeps == ec.sweeps and jc.edges_touched == 0.0


@pytest.mark.parametrize("workload", ["boolean", "tropical", "counting"])
def test_resume_bit_identical_across_families(workload):
    for name, (jg, g) in GRAPHS.items():
        w = _weights(g, workload)
        srcs = np.arange(min(24, g.n_nodes), dtype=np.int32)
        kw = dict(workload=workload, weights=w, options=OPTS, chunk_size=8,
                  device="cpu")
        full = run_sweep_job(g, srcs, **kw)
        with tempfile.TemporaryDirectory() as d:
            with pytest.raises(_Preempt):
                run_sweep_job(g, srcs, checkpoint_dir=d,
                              on_chunk=_kill_after(0), **kw)
            res = run_sweep_job(g, srcs, checkpoint_dir=d, **kw)
        _assert_equal(res, full, counters=False)
        assert res.chunks_restored >= 1, name
        assert res.chunks_computed == res.chunks_total - res.chunks_restored
        assert res.restored_step == res.chunks_restored
        assert res.corrupt_skipped == 0


def test_kill_inside_checkpoint_interval_recomputes_tail():
    _, g = GRAPHS["random_ragged"]
    srcs = np.arange(32, dtype=np.int32)          # 4 chunks of 8
    kw = dict(workload="boolean", options=OPTS, chunk_size=8, device="cpu")
    full = run_sweep_job(g, srcs, **kw)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(_Preempt):
            run_sweep_job(g, srcs, checkpoint_dir=d, checkpoint_interval=2,
                          on_chunk=_kill_after(2), **kw)
        assert C.latest_step(d) == 2              # chunk 2 never landed
        res = run_sweep_job(g, srcs, checkpoint_dir=d,
                            checkpoint_interval=2, **kw)
    _assert_equal(res, full, counters=False)
    assert res.chunks_restored == 2 and res.chunks_computed == 2


def test_corrupt_checkpoint_falls_back_to_older():
    _, g = GRAPHS["random_ragged"]
    srcs = np.arange(32, dtype=np.int32)
    kw = dict(workload="boolean", options=OPTS, chunk_size=8, device="cpu")
    full = run_sweep_job(g, srcs, **kw)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(_Preempt):
            run_sweep_job(g, srcs, checkpoint_dir=d,
                          on_chunk=_kill_after(2), **kw)
        assert C.latest_step(d) == 3
        with open(os.path.join(d, "step_000000003", "0000.bin"),
                  "r+b") as f:
            f.write(b"\xde\xad\xbe\xef")
        res = run_sweep_job(g, srcs, checkpoint_dir=d, **kw)
    _assert_equal(res, full, counters=False)
    assert res.corrupt_skipped == 1
    assert res.restored_step == 2 and res.chunks_restored == 2


def test_unreadable_manifest_counts_as_corrupt():
    _, g = GRAPHS["path"]
    srcs = np.arange(16, dtype=np.int32)
    kw = dict(workload="boolean", options=OPTS, chunk_size=8, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        run_sweep_job(g, srcs, checkpoint_dir=d, **kw)
        with open(os.path.join(d, "step_000000002", "MANIFEST.json"),
                  "w") as f:
            f.write("{not json")
        res = run_sweep_job(g, srcs, checkpoint_dir=d, **kw)
    assert res.corrupt_skipped == 1 and res.restored_step == 1
    assert res.chunks_computed == 1


def test_mismatched_job_refuses_to_resume():
    _, g = GRAPHS["random_ragged"]
    _, other = GRAPHS["path"]
    kw = dict(workload="boolean", options=OPTS, chunk_size=8, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        run_sweep_job(g, np.arange(16), checkpoint_dir=d, **kw)
        with pytest.raises(JobMismatchError):
            run_sweep_job(g, np.arange(24), checkpoint_dir=d, **kw)
        with pytest.raises(JobMismatchError):
            run_sweep_job(other, np.arange(16), checkpoint_dir=d, **kw)
        with pytest.raises(JobMismatchError):
            run_sweep_job(g, np.arange(16), checkpoint_dir=d,
                          **dict(kw, chunk_size=4))


def test_finished_job_restores_without_compute():
    _, g = GRAPHS["path"]
    srcs = np.arange(16, dtype=np.int32)
    kw = dict(workload="boolean", options=OPTS, chunk_size=8, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        first = run_sweep_job(g, srcs, checkpoint_dir=d, **kw)
        again = run_sweep_job(g, srcs, checkpoint_dir=d, **kw)
    _assert_equal(again, first, counters=False)
    assert again.chunks_computed == 0
    assert again.chunks_restored == again.chunks_total
    assert again.checkpoints_written == 0
    with tempfile.TemporaryDirectory() as d:
        run_sweep_job(g, srcs, checkpoint_dir=d, **kw)
        redo = run_sweep_job(g, srcs, checkpoint_dir=d, resume=False, **kw)
    assert redo.chunks_computed == redo.chunks_total
    _assert_equal(redo, first, counters=False)


def test_facade_checkpointed_apsp():
    jg, g = GRAPHS["two_components"]
    h = repro_torch.prepare(g, source_batch=8, mode="sparse", device="cpu")
    srcs = np.arange(24, dtype=np.int32)
    plain = h.apsp(srcs)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(_Preempt):
            h.apsp(srcs, checkpoint_dir=d, chunk_size=8,
                   on_chunk=_kill_after(0))
        res = h.apsp(srcs, checkpoint_dir=d, chunk_size=8)
        assert C.read_manifest(d, 3)["meta"]["mode"] == "sparse"
        w = _weights(g, "tropical")
        ht = repro_torch.prepare(g, weights=w, source_batch=8, mode="sparse",
                                 device="cpu")
        tj = ht.apsp(srcs, semiring="tropical",
                     checkpoint_dir=os.path.join(d, "w"))
        np.testing.assert_array_equal(
            tj.dist, ht.apsp(srcs, semiring="tropical").dist.numpy())
    assert isinstance(res, JobResult)
    np.testing.assert_array_equal(res.dist, plain.dist.numpy())
    assert res.sweeps == plain.sweeps
    assert res.chunks_restored == 1 and res.restored_step == 1
    # mesh= jobs run on CPU meshes in tests/test_torch_distributed.py; a
    # foreign mesh object raises before any checkpoint is written
    with pytest.raises(ValueError, match="DeviceMesh"):
        h.apsp(srcs, checkpoint_dir="ckpt", mesh=object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        run_sweep_job(g, srcs, mesh=object(), device="cpu")
    assert not os.path.exists("ckpt")
    with pytest.raises(ValueError, match="unknown workload"):
        run_sweep_job(g, srcs, workload="minlabel", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_sweep_job(g, srcs)


def test_mutated_dynamic_graph_invalidates_checkpoints():
    _, src, dst, n = [f for f in adversarial_families(0)
                      if f[0] == "path"][0]
    dg = DynamicCSRGraph.from_edges(src, dst, n, device="cpu")
    jd = JDynamic.from_edges(src, dst, n)
    srcs = np.arange(8, dtype=np.int32)
    kw = dict(workload="boolean", chunk_size=4, resume=True)
    with tempfile.TemporaryDirectory() as d:
        res = run_sweep_job(dg, srcs, options=OPTS, checkpoint_dir=d,
                            device="cpu", **kw)
        want = jrun(jd, srcs, options=J_OPTS, **kw)
        _assert_equal(res, want, counters=False)
        man = C.read_manifest(d, 2)
        dg.insert_edges([0], [n - 1])
        with pytest.raises(JobMismatchError):
            run_sweep_job(dg, srcs, options=OPTS, checkpoint_dir=d,
                          device="cpu", **kw)
        # the JAX package, on the same mutation, fingerprints alike
        jd.insert_edges([0], [n - 1])
        jdir = os.path.join(d, "jax")
        jrun(jd, srcs, options=J_OPTS, checkpoint_dir=jdir, **kw)
        tdir = os.path.join(d, "torch")
        run_sweep_job(dg, srcs, options=OPTS, checkpoint_dir=tdir,
                      device="cpu", **kw)
        assert C.read_manifest(tdir, 2)["meta"] == \
            C.read_manifest(jdir, 2)["meta"]
        assert C.read_manifest(tdir, 2)["meta"]["epoch"] == 1
        assert man["meta"]["epoch"] == 0


# -- the hard fields of bench_resume --quick ----------------------------------

def test_bench_resume_quick_hard_fields():
    base = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                      .read_text())["bench_resume"]
    row = base["families"]["grid_road"]
    chunk_size = base["chunk_size"]
    g = _port(jgen.grid2d(32, 32))
    sources = np.arange(min(32, g.n_nodes), dtype=np.int32)
    opts = SweepOptions(source_batch=chunk_size, mode="sparse")

    def job(ckpt_dir, on_chunk=None):
        return run_sweep_job(g, sources, workload="counting", options=opts,
                             chunk_size=chunk_size, checkpoint_dir=ckpt_dir,
                             checkpoint_interval=1, on_chunk=on_chunk,
                             device="cpu")

    with tempfile.TemporaryDirectory() as td:
        full = job(os.path.join(td, "full"))
        kill_at = full.chunks_total // 2 - 1
        fixture = os.path.join(td, "killed")
        with pytest.raises(RuntimeError, match="injected preemption"):
            job(fixture, on_chunk=bench_kill_after(kill_at))
        resume_dir = os.path.join(td, "resume0")
        shutil.copytree(fixture, resume_dir)
        resumed = job(resume_dir)
    _assert_equal(resumed, full, counters=False)
    got = {"n_sources": int(len(sources)),
           "chunks_total": full.chunks_total, "sweeps": full.sweeps,
           "dist_checksum": int(np.asarray(full.dist, np.int64).sum()),
           "sigma_checksum": float(np.asarray(full.sigma).sum()),
           "checkpoints_written": full.checkpoints_written,
           "resumed_chunks": resumed.chunks_restored,
           "recomputed_chunks": resumed.chunks_computed}
    assert got == {k: row[k] for k in got}

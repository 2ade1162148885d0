"""The port's sharded executor (``repro_torch.core.distributed``) on CPU
meshes of gloo ranks, against the single-device engines of both packages
and against the JAX executor on the same mesh shape.

One world of 8 ranks (``tests/torch_mesh_ranks.py``, subprocesses that
import no JAX) runs every case once and saves its arrays; each case is a
test of its own here.  Meshes (1,), (8,), (2, 4) and (4, 2) (the (1,) one
a subset of the world), all three semirings and modes:

  * ``dist``, ``sweeps`` and ``sigma`` bit for bit against
    ``apsp_engine`` (push), ``weighted_apsp`` (dense) and
    ``counting_apsp`` (push) of both packages, and on every rank;
  * in ``auto`` mode ``direction_counts`` and ``edges_touched`` against
    ``repro.core.sharded_apsp`` on the same mesh shape, computed in one
    JAX subprocess with 8 virtual CPU devices (the cost model's mean over
    the data shards depends on the mesh shape);
  * the kernel path (``use_kernel=True``) on a (2, 2) mesh: the plain
    versions of K1, K5, K7 and K9 on K-row blocks and partitioned lanes;
  * the wiring: the facade, ``centrality(mesh=)`` (float fields at rtol
    1e-6 / atol 1e-9, the rest exact), ``GraphService`` on a (1, 1) mesh,
    and the elastic counting job killed on (4, 2) and resumed through
    ``plan_remesh`` → ``mesh_from_plan`` → ``restore(shardings=)`` on
    (2, 2).
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_ranks as W
from oracles import bfs_dist, bfs_dists, bfs_sigmas, dijkstra_dist
from repro.core import (CentralityConfig as JCentralityConfig,
                        EngineConfig as JEngineConfig,
                        WeightedConfig as JWeightedConfig)
from repro.core import apsp_engine as japsp
from repro.core import counting_apsp as jcounting
from repro.core import weighted_apsp as jweighted
from repro.graph import generators as jgen
from repro_torch.core import (CentralityConfig, EngineConfig, ShardedConfig,
                              WeightedConfig, apsp_engine, counting_apsp,
                              sharded_apsp, weighted_apsp)
from repro_torch.graph import generators as tgen
from repro_torch.graph.csr import _round_up
from repro_torch.launch import mesh as M

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-6, 1e-9

JAX_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import numpy as np
import torch_mesh_ranks as W
from repro.core import ShardedConfig, sharded_apsp
from repro.core.centrality import centrality
from repro.graph import generators as gen
from repro.launch import mesh as M
from repro.train.fault_tolerance import plan_remesh
g = gen.rmat(W.RMAT["scale"], W.RMAT["edge_factor"],
             directed=W.RMAT["directed"], seed=W.RMAT["seed"])
w = W._weights(g, 0, 0.5, 4.0)
srcs = np.arange(W.N_SOURCES, dtype=np.int32)
out = {{"auto": {{}}, "plans": {{}}}}
for name in ("8", "2x4"):
    mesh = M.make_mesh(*W.MESHES[name])
    for sr in W.SEMIRINGS:
        r = sharded_apsp(g, srcs, mesh=mesh,
                         weights=w if sr == "tropical" else None,
                         config=ShardedConfig(semiring=sr, mode="auto"))
        out["auto"][name + "." + sr] = [
            np.asarray(r.direction_counts).tolist(), float(r.edges_touched),
            int(r.sweeps)]
c = centrality(g, srcs, mesh=M.make_mesh(*W.MESHES["8"]))
out["centrality"] = {{f: np.asarray(getattr(c, f)).tolist() for f in (
    "closeness", "harmonic", "eccentricity", "betweenness", "radius",
    "diameter", "sweeps", "sigma_checksum")}}
for alive, mp in W.PLANS:
    m = M.mesh_from_plan(plan_remesh(alive, model_parallel=mp))
    out["plans"][f"{{alive}}.{{mp}}"] = [list(m.devices.shape),
                                      list(m.axis_names),
                                      list(M.dp_axes(m)), M.dp_size(m)]
try:
    M.make_production_mesh()
    out["production_mesh_raised"] = 0
except Exception:
    out["production_mesh_raised"] = 1
print(json.dumps(out))
"""


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world and the JAX executor's subprocess, run at once."""
    ranks = W.start("executor", 8, tmp_path_factory.mktemp("mesh"))
    script = JAX_SCRIPT.format(src=str(ROOT / "src"),
                               tests=str(ROOT / "tests"))
    jax_proc = subprocess.Popen([sys.executable, "-c", script],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    try:
        out, err = jax_proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        jax_proc.kill()
        raise
    assert jax_proc.returncode == 0, err[-4000:]
    return ranks.results(), json.loads(out.strip().splitlines()[-1])


def _both(jg, tg, n_sources, weights, batch):
    """Single-device engine results of both packages, per semiring."""
    srcs = np.arange(n_sources, dtype=np.int32)
    jax = {
        "boolean": japsp(jg, srcs, config=JEngineConfig(
            mode="push", source_batch=batch)),
        "tropical": jweighted(jg, weights, srcs, config=JWeightedConfig(
            mode="dense", source_batch=batch)),
        "counting": jcounting(jg, srcs, config=JCentralityConfig(
            mode="push", source_batch=batch)),
    }
    port = {
        "boolean": apsp_engine(tg, srcs, config=EngineConfig(
            mode="push", source_batch=batch)),
        "tropical": weighted_apsp(tg, weights, srcs, config=WeightedConfig(
            mode="dense", source_batch=batch)),
        "counting": counting_apsp(tg, srcs, config=CentralityConfig(
            mode="push", source_batch=batch)),
    }
    return jax, port


def _graph(name):
    """(the JAX graph, the port's) of one recipe, the port's on the CPU;
    the rank side builds the same graphs."""
    recipes = {
        "rmat": (lambda m: m.rmat(W.RMAT["scale"], W.RMAT["edge_factor"],
                                  directed=W.RMAT["directed"],
                                  seed=W.RMAT["seed"])),
        "er237": (lambda m: m.erdos_renyi(237, 3.0, seed=9)),
        "kernel": (lambda m: m.rmat(7, 4, directed=False, seed=3)),
        "job": (lambda m: m.rmat(8, 6, directed=False, seed=5)),
        "ws": (lambda m: m.watts_strogatz(96, 6, 0.1, seed=3)),
    }
    jg = recipes[name](jgen)
    tg = recipes[name](_OnCpu())
    np.testing.assert_array_equal(np.asarray(jg.src), tg.src.numpy())
    np.testing.assert_array_equal(np.asarray(jg.dst), tg.dst.numpy())
    return jg, tg


class _OnCpu:
    """The port's generators with ``device="cpu"``."""

    def __getattr__(self, name):
        fn = getattr(tgen, name)
        return lambda *a, **k: fn(*a, device="cpu", **k)


@pytest.fixture(scope="module")
def singles():
    out = {}
    for name, n_sources, (seed, lo, hi), batch in (
            ("rmat", W.N_SOURCES, (0, 0.5, 4.0), 24),
            ("er237", 13, (1, 0.1, 5.0), 16),
            ("kernel", 8, (0, 0.5, 4.0), 8)):
        jg, tg = _graph(name)
        out[name] = _both(jg, tg, n_sources, W._weights(jg, seed, lo, hi),
                          batch)
    return out


def _check(ranks, key, semiring, refs, *, pinned=None):
    """``key``'s result on rank 0 equals every reference engine result bit
    for bit, and every rank that ran it holds the same arrays."""
    got = ranks[0]
    for ref in refs:
        np.testing.assert_array_equal(got[f"{key}.dist"],
                                      np.asarray(ref.dist))
        assert int(got[f"{key}.sweeps"]) == int(ref.sweeps), key
        if semiring == "counting":
            np.testing.assert_array_equal(got[f"{key}.sigma"],
                                          np.asarray(ref.sigma))
    if pinned is not None:
        sweeps = int(got[f"{key}.sweeps"])
        want = [sweeps, 0] if pinned == "dense" else [0, sweeps]
        assert got[f"{key}.dirs"].tolist() == want, key
    held = [r for r in ranks if f"{key}.dist" in r]
    assert held
    for r in held:
        for field in ("dist", "sweeps", "dirs", "sigma", "edges"):
            if f"{key}.{field}" in got:
                np.testing.assert_array_equal(r[f"{key}.{field}"],
                                              got[f"{key}.{field}"])


CASES = [(m, sr, mode) for m in W.MESHES for sr in W.SEMIRINGS
         for mode in W.MODES]


@pytest.mark.parametrize("mesh,semiring,mode", CASES)
def test_sharded_equals_single_device_engines(world, singles, mesh,
                                              semiring, mode):
    ranks, _ = world
    jax, port = singles["rmat"]
    key = f"mesh.{mesh}.{semiring}.{mode}"
    _check(ranks, key, semiring, (jax[semiring], port[semiring]),
           pinned=None if mode == "auto" else mode)
    if semiring != "counting":
        # exact integer partial sums: the same Eq. 10 total as one device
        assert float(ranks[0][f"{key}.edges"]) == \
            float(port[semiring].edges_touched)


@pytest.mark.parametrize("semiring", W.SEMIRINGS)
def test_prepared_operand_handed_over(world, singles, semiring):
    """At C == 1 ``prepare_sharded(dense_op=prepared graph)`` holds the
    prepared graph's own operand (no second copy) and gives the engines'
    results; a bare tensor, a graph prepared at another padded size, or a
    dense operand for a config that never dispatches it, is refused."""
    ranks, _ = world
    jax, port = singles["rmat"]
    assert int(ranks[0][f"handover.{semiring}.same_tensor"]) == 1
    _check(ranks, f"handover.{semiring}", semiring,
           (jax[semiring], port[semiring]), pinned="dense")
    assert int(ranks[0]["handover.refused"]) == 3


@pytest.mark.parametrize("semiring,mode",
                         [(sr, m) for sr in W.SEMIRINGS
                          for m in ("dense", "sparse")])
def test_non_divisible_padding(world, singles, semiring, mode):
    """n = 237 does not divide the 4-way vertex shard nor 13 sources the
    2-way source shard."""
    ranks, _ = world
    jax, port = singles["er237"]
    _check(ranks, f"ragged.{semiring}.{mode}", semiring,
           (jax[semiring], port[semiring]), pinned=mode)


@pytest.mark.parametrize("mesh,semiring",
                         [(m, sr) for m in ("8", "2x4")
                          for sr in W.SEMIRINGS])
def test_auto_counters_equal_jax_executor(world, mesh, semiring):
    ranks, jax_out = world
    dirs, edges, sweeps = jax_out["auto"][f"{mesh}.{semiring}"]
    key = f"mesh.{mesh}.{semiring}.auto"
    assert ranks[0][f"{key}.dirs"].tolist() == dirs
    assert float(ranks[0][f"{key}.edges"]) == edges
    assert int(ranks[0][f"{key}.sweeps"]) == sweeps


@pytest.mark.parametrize("semiring,mode",
                         [("boolean", "dense"), ("counting", "dense"),
                          ("tropical", "dense"), ("tropical", "sparse")])
def test_kernel_path_on_cpu_ranks(world, singles, semiring, mode):
    """use_kernel=True on a (2, 2) mesh: K1, K5, K7 (K-row blocks) and K9
    (partitioned lanes), their plain versions on CPU tensors."""
    ranks, _ = world
    jax, port = singles["kernel"]
    _check(ranks, f"kernel.{semiring}.{mode}", semiring,
           (jax[semiring], port[semiring]), pinned=mode)


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_mesh_packs_through_pack_frontier(world, mode):
    """On a (2, 2) mesh every boolean sweep packs its new bits for the
    OR combine through ``pack_frontier``, and on the kernel path (dense)
    K1's K-block frontier too: once a sweep each."""
    ranks, _ = world
    held = [r for r in ranks if f"packs.{mode}" in r]
    assert len(held) == 4
    for r in held:
        sweep, combine, sweeps = r[f"packs.{mode}"].tolist()
        assert sweeps > 1 and combine == sweeps
        assert sweep == (sweeps if mode == "dense" else 0)


@pytest.mark.parametrize("semiring", W.SEMIRINGS)
def test_facade_mesh(world, singles, semiring):
    """prepare(g).apsp(mesh=) on (2, 4); a second call reuses the cached
    operands."""
    ranks, _ = world
    jax, port = singles["rmat"]
    _check(ranks, f"facade.{semiring}", semiring,
           (jax[semiring], port[semiring]), pinned="dense")
    assert int(ranks[0][f"facade.{semiring}.cached"]) == 1


def test_centrality_mesh_matches_jax(world):
    ranks, jax_out = world
    ref = jax_out["centrality"]
    for f in ("closeness", "eccentricity", "radius", "diameter", "sweeps",
              "sigma_checksum"):
        np.testing.assert_array_equal(ranks[0][f"centrality.{f}"],
                                      np.asarray(ref[f]))
    for f in ("harmonic", "betweenness"):
        np.testing.assert_allclose(ranks[0][f"centrality.{f}"],
                                   np.asarray(ref[f]), rtol=RTOL, atol=ATOL)
    for r in ranks[1:]:
        for k in ranks[0]:
            if k.startswith("centrality."):
                np.testing.assert_array_equal(r[k], ranks[0][k])


def test_graph_service_routes_large_flushes_to_the_mesh(world):
    """As ``tests/test_serving.py``: flushes at or above the threshold run
    on the (1, 1) mesh, answers exact; smaller flushes stay single."""
    ranks, _ = world
    got = ranks[0]
    g, _ = _graph("ws")
    w = W._weights(g, 0, 0.5, 3.0)
    assert int(got["serve.flushes"]) == 2
    assert got["serve.by"].tolist() == ["sharded"] * 10
    for i in range(10):
        weighted = i >= 5
        target = None if i % 2 else 90
        ref = dijkstra_dist(g, w, i) if weighted else bfs_dist(g, i)
        if target is None:
            if weighted:
                np.testing.assert_allclose(got[f"serve.q{i}"], ref,
                                           rtol=1e-6)
            else:
                np.testing.assert_array_equal(got[f"serve.q{i}"], ref)
        else:
            np.testing.assert_allclose(float(got[f"serve.q{i}"]),
                                       ref[target], rtol=1e-6)
    assert int(got["serve.small_flushes"]) == 0
    assert all("serve.flushes" not in r for r in ranks[1:])


def test_elastic_counting_job_resumes_on_a_smaller_mesh(world):
    """Killed after chunk 1 on (4, 2); host 1 found dead; resumed on the
    (2, 2) mesh of plan_remesh — bit-identical with its counters."""
    ranks, _ = world
    got = ranks[0]
    assert int(got["job.single_equal"]) == 1
    assert got["job.dead"].tolist() == [1]
    assert got["job.small_shape"].tolist() == [2, 2]
    g, _ = _graph("job")
    np.testing.assert_allclose(got["job.full.sigma"],
                               bfs_sigmas(g, np.arange(32)))
    full, res = got["job.full.counters"], got["job.resumed.counters"]
    # sweeps, edges_touched, chunks_total equal; 2 restored, 2 computed
    assert full[:3].tolist() == res[:3].tolist() and full[1] > 0
    assert res[3:].tolist() == [2.0, 2.0, 2.0]
    for f in ("dist", "sigma", "dirs"):
        np.testing.assert_array_equal(got[f"job.resumed.{f}"],
                                      got[f"job.full.{f}"])
    for r in ranks[1:4]:
        for f in ("dist", "sigma", "dirs", "counters"):
            np.testing.assert_array_equal(r[f"job.resumed.{f}"],
                                          got[f"job.resumed.{f}"])
    assert all("job.resumed.dist" not in r for r in ranks[4:])
    # restore(shardings=): the leaf replicated on this rank's device
    assert str(got["restore.device"]) == "cpu"
    assert got["restore.a"].tolist() == [0, 1, 2]


def test_boolean_job_resume_and_edge_counter_parity(world):
    ranks, _ = world
    got = ranks[0]
    a, b = got["bjob.edges"].tolist()
    assert a == b > 0
    g, _ = _graph("er237")
    np.testing.assert_array_equal(got["bjob.full.dist"],
                                  bfs_dists(g, np.arange(24)))
    full, res = got["bjob.full.counters"], got["bjob.resumed.counters"]
    assert full[:2].tolist() == res[:2].tolist() and res[2] == 1
    for f in ("dist", "dirs"):
        np.testing.assert_array_equal(got[f"bjob.resumed.{f}"],
                                      got[f"bjob.full.{f}"])


@pytest.mark.parametrize("plan", [f"{a}.{m}" for a, m in W.PLANS])
def test_mesh_from_plan_matches_jax(world, plan):
    ranks, jax_out = world
    shape, names, dp, size = jax_out["plans"][plan]
    got = ranks[0]
    assert got[f"plan.{plan}.shape"].tolist() == shape
    assert got[f"plan.{plan}.names"].tolist() == names
    assert [a for a in got[f"plan.{plan}.dp_axes"].tolist() if a] == dp
    assert int(got[f"plan.{plan}.dp_size"]) == size
    n = int(np.prod(shape))
    assert [int(r[f"plan.{plan}.member"]) for r in ranks] == \
        [1] * n + [0] * (8 - n)
    assert int(got["production_mesh_raised"]) == 1 == \
        jax_out["production_mesh_raised"]


def test_make_mesh_needs_cuda_or_a_cpu_group(monkeypatch):
    """make_mesh() defaults to the card and raises without CUDA, as
    resolve_device does; a CPU mesh needs the caller's process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_test_mesh(2)
    with pytest.raises(RuntimeError, match="init_process_group"):
        M.make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="pair up"):
        M.make_mesh((2, 2), ("data",), device="cpu")


def test_sharded_entry_validation():
    g = tgen.grid2d(4, 4, device="cpu")
    with pytest.raises(ValueError, match="semiring"):
        ShardedConfig(semiring="min_label")
    with pytest.raises(ValueError, match="mode"):
        ShardedConfig(mode="push")
    assert ShardedConfig(max_sweeps=3).max_steps == 3
    assert ShardedConfig().need_dense and not ShardedConfig().need_sparse
    with pytest.raises(ValueError, match="needs mesh="):
        sharded_apsp(g, [0])
    with pytest.raises(ValueError, match="DeviceMesh"):
        sharded_apsp(g, [0], mesh=object())


# the traced calls of the rank suite: (data extent D, model extent C,
# n, sources) of each
TRACED = {"trace.boolean": (2, 4, 512, W.N_SOURCES),
          "trace.tropical": (2, 4, 512, W.N_SOURCES),
          "trace.counting": (2, 4, 512, W.N_SOURCES),
          "trace.packed": (2, 2, 128, W.N_SOURCES)}


def test_mesh_window_table_is_empty_with_the_profiler_off(world):
    ranks, _ = world
    assert [int(r["trace.off_window_empty"]) for r in ranks] == [1] * 8


@pytest.mark.parametrize("key", sorted(TRACED))
def test_mesh_spans_and_counters(world, key):
    """Under the profiler a vertex-sharded call records one
    ``dawn.mesh.combine`` a sweep, a ``dawn.mesh.gather`` per all-gather
    and a ``dawn.mesh.reduce`` per all-reduce, as ``record_function``
    ranges too; ``dawn.mesh.gather_bytes`` is what the rank received from
    the other ranks: (C - 1) slices of packed words a boolean sweep, and
    (D - 1) slices of each result gathered over the data axis."""
    ranks, _ = world
    D, C, n, s = TRACED[key]
    semiring = "boolean" if key == "trace.packed" else key.split(".")[1]
    n_pad = _round_up(n + 1, 128 * C)
    s_l = _round_up(s, 8 * D) // D
    held = [r for r in ranks if f"{key}.dist" in r]
    assert len(held) == D * C
    for r in held:
        sweeps = int(r[f"{key}.sweeps"])
        assert r[f"{key}.dirs"].tolist() == [sweeps, 0]
        assert int(r[f"{key}.counted_sweeps"]) == sweeps
        assert int(r[f"{key}.in_events"]) == 1
        results = 2 if semiring == "counting" else 1     # dist (+ sigma)
        received = results * (D - 1) * s_l * n * 4
        if semiring == "boolean":
            received += sweeps * (C - 1) * s_l * (n_pad // 32) * 4
        assert int(r[f"{key}.gather_bytes"]) == received
        assert int(r[f"{key}.combine"]) == sweeps
        assert int(r[f"{key}.gather"]) == results + \
            (sweeps if semiring == "boolean" else 0)
        # Fact 1 over both axes a sweep, the MIN / SUM combines, and the
        # edge counter over the data axis
        assert int(r[f"{key}.reduce"]) == 2 * sweeps + 1 + \
            (0 if semiring == "boolean" else sweeps)
    # tracing changes no result
    untraced = "kernel.boolean.dense" if key == "trace.packed" else \
        f"mesh.2x4.{semiring}.dense"
    want = ranks[0][f"{untraced}.dist"]
    np.testing.assert_array_equal(held[0][f"{key}.dist"][: len(want)], want)


@pytest.mark.parametrize("key", sorted(TRACED))
def test_mesh_block_setup_span_and_gauge(world, key):
    """``prepare_sharded`` builds the rank's K-row block in one
    ``dawn.mesh.block`` set-up span, and ``dawn.mesh.block_bytes`` is the
    block it holds: packed words on the kernel path, else (n_pad / C,
    n_pad) int8 or f32."""
    ranks, _ = world
    _, C, n, _ = TRACED[key]
    n_pad = _round_up(n + 1, 128 * C)
    want = [n_pad, n_pad // C // 32] if key == "trace.packed" else \
        [n_pad // C, n_pad]
    held = [r for r in ranks if f"{key}.dist" in r]
    for r in held:
        assert int(r[f"{key}.block_n"]) == 1
        assert r[f"{key}.block_shape"].tolist() == want
        size = 4 if key in ("trace.packed", "trace.tropical") else 1
        assert int(r[f"{key}.block_bytes"]) == \
            int(r[f"{key}.block_held"]) == want[0] * want[1] * size

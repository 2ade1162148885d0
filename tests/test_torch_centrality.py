"""The port's centrality analytics against ``repro.core.centrality`` on
the CPU, measure by measure, and against the NumPy Brandes oracle.

Exact: ``eccentricity``, ``radius``, ``diameter``, closeness (float64
from exact integer statistics), ``sweeps`` and ``sigma_checksum`` (an
f32 sum of integers below 2^24 at these sizes).  Within a tolerance:
``betweenness``, ``harmonic`` and the dependencies ``delta`` — f32
scatter-adds and f32 partial sums taken in another order than XLA's, so
rtol 1e-6 and atol 1e-9 against JAX; rtol 1e-4 against the oracle, as
the JAX package's own tests hold it."""
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from oracles import (brandes_betweenness, closeness_centrality,
                     eccentricities, harmonic_centrality)
from repro.graph import generators as jgen
from repro.graph.csr import CSRGraph as JCSR
from repro_torch.convert import csr_from_arrays
from repro_torch.core import autotune
from repro_torch.graph import generators as tgen

jcent = importlib.import_module("repro.core.centrality")
tcent = importlib.import_module("repro_torch.core.centrality")

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
RTOL, ATOL = 1e-6, 1e-9

FAMILIES = {
    "grid": lambda: jgen.grid2d(9, 9),
    "rmat": lambda: jgen.rmat(7, 4, directed=False, seed=2),
    "er_directed": lambda: jgen.erdos_renyi(90, 3.0, seed=9),
    "ws": lambda: jgen.watts_strogatz(96, 6, 0.1, seed=4),
    "disconnected": lambda: jgen.disconnected(4, 24, 3.0, seed=5),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def carry(jg):
    return csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                           n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                           m_pad=jg.m_pad, device="cpu")


def assert_same_centrality(rj, rt):
    np.testing.assert_array_equal(rj.sources, rt.sources)
    for name in ("closeness", "eccentricity"):
        want, got = getattr(rj, name), getattr(rt, name)
        assert (want is None) == (got is None), name
        if want is not None:
            np.testing.assert_array_equal(want, got, err_msg=name)
    for name in ("harmonic", "betweenness"):
        want, got = getattr(rj, name), getattr(rt, name)
        assert (want is None) == (got is None), name
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
    assert (rj.radius, rj.diameter) == (rt.radius, rt.diameter)
    assert int(rj.sweeps) == rt.sweeps
    assert float(rj.sigma_checksum) == rt.sigma_checksum


# every family with all four measures; each measure subset (which drops
# the counting engine or the reductions) on two families
MEASURE_CASES = [(fam, jcent.MEASURES) for fam in sorted(FAMILIES)] + [
    (fam, measures) for fam in ("rmat", "er_directed")
    for measures in (("closeness", "harmonic"), ("eccentricity",),
                     ("betweenness",))]


@pytest.mark.parametrize("family,measures", MEASURE_CASES)
def test_centrality_matches_jax(family, measures):
    jg = FAMILIES[family]()
    sources = np.arange(0, jg.n_nodes, 3, dtype=np.int32)[:24]
    rj = jcent.centrality(jg, sources, measures=measures)
    rt = tcent.centrality(carry(jg), sources, measures=measures)
    assert_same_centrality(rj, rt)


@pytest.mark.parametrize("config", [
    dict(mode="push", use_kernel=False), dict(mode="sparse"),
    dict(use_kernel=True), dict(use_kernel=True, fused_steps=-1)])
def test_centrality_configs_match_jax(config):
    jg = FAMILIES["rmat"]()
    sources = np.arange(40, dtype=np.int32)
    cfg = dict(source_batch=16, **config)
    rj = jcent.centrality(jg, sources,
                          config=jcent.CentralityConfig(**cfg))
    rt = tcent.centrality(carry(jg), sources,
                          config=tcent.CentralityConfig(**cfg))
    assert_same_centrality(rj, rt)


@pytest.mark.parametrize("family", ["ws", "er_directed"])
def test_brandes_dependencies_match_jax(family):
    jg = FAMILIES[family]()
    sources = np.arange(16, dtype=np.int32)
    res = jcent.counting_apsp(jg, sources,
                              config=jcent.CentralityConfig(source_batch=16))
    dist, sigma = np.array(res.dist), np.array(res.sigma)
    want = np.asarray(jcent.brandes_dependencies(jg, jnp.asarray(dist),
                                                 jnp.asarray(sigma)))
    got = tcent.brandes_dependencies(carry(jg), torch.from_numpy(dist),
                                     torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", range(4))
def test_betweenness_matches_brandes_oracle(seed):
    rng = np.random.default_rng(seed * 4001 + 17)
    n = int(rng.integers(4, 81))
    m = max(1, int(n * float(rng.uniform(1.0, 5.0))))
    jg = JCSR.from_edges(rng.integers(0, n, m), rng.integers(0, n, m), n)
    np.testing.assert_allclose(tcent.betweenness(carry(jg)),
                               brandes_betweenness(jg), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_bench_centrality_quick_figures(use_kernel):
    """The hard fields of ``bench_centrality --quick`` on ws_small: 32
    sources in one batch of 32 give sweeps 12 and sigma_checksum 62910.0,
    on the reference and on the kernel path."""
    base = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                      .read_text())["bench_centrality"]["families"][
                          "ws_small"]
    g = tgen.watts_strogatz(256, 6, 0.05, seed=3, device="cpu")
    assert (g.n_nodes, g.n_edges) == (base["n_nodes"], base["n_edges"])
    sources = np.arange(base["n_sources"], dtype=np.int32)
    res = tcent.centrality(g, sources, config=tcent.CentralityConfig(
        source_batch=32, use_kernel=use_kernel))
    assert (res.sweeps, base["sweeps"]) == (12, 12)
    assert res.sigma_checksum == base["sigma_checksum"] == 62910.0


def test_per_measure_wrappers_match_jax_and_oracles():
    jg = FAMILIES["er_directed"]()
    tg = carry(jg)
    src = np.arange(0, jg.n_nodes, 2, dtype=np.int32)
    np.testing.assert_array_equal(tcent.closeness(tg, src, block=16),
                                  jcent.closeness(jg, src, block=16))
    np.testing.assert_allclose(tcent.closeness(tg, src, block=16),
                               closeness_centrality(jg, src), rtol=1e-12)
    np.testing.assert_allclose(tcent.harmonic(tg, src, method="sovm"),
                               harmonic_centrality(jg, src), rtol=1e-6)
    np.testing.assert_allclose(
        tcent.betweenness(tg, normalized=True),
        jcent.betweenness(jg, normalized=True), rtol=RTOL, atol=ATOL)
    ecc = tcent.eccentricity(tg)
    want = jcent.eccentricity(jg)
    np.testing.assert_array_equal(ecc["ecc"], want["ecc"])
    np.testing.assert_array_equal(ecc["ecc"], eccentricities(jg))
    assert (ecc["radius"], ecc["diameter"]) == (want["radius"],
                                                want["diameter"])
    assert tcent.eccentricity_sample(tg, 16, seed=3, method="bovm") == \
        jcent.eccentricity_sample(jg, 16, seed=3, method="bovm")


def test_centrality_validation_errors():
    tg = carry(FAMILIES["grid"]())
    with pytest.raises(ValueError, match="unknown measures"):
        tcent.centrality(tg, [0], measures=("pagerank",))
    with pytest.raises(ValueError, match="empty source list"):
        tcent.centrality(tg, [])
    with pytest.raises(ValueError, match="sources must be in"):
        tcent.centrality(tg, [tg.n_nodes])
    # mesh= runs on a CPU mesh in tests/test_torch_distributed.py; a
    # foreign mesh object raises
    with pytest.raises(ValueError, match="DeviceMesh"):
        tcent.centrality(tg, [0], mesh=object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        tcent.betweenness(tg, [0], mesh=object())
    # the autotuner is ported: a config takes a plan
    plan = autotune.build_plan(tg, use_hlo=False)
    assert tcent.CentralityConfig(tuning=plan).tuning is plan
    with pytest.raises(ValueError, match="mode"):
        tcent.CentralityConfig(mode="pull")
    with pytest.raises(ValueError, match="method"):
        tcent.centrality(tg, [0], measures=("closeness",), method="bfs")

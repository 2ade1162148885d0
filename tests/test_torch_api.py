"""The port's facade against ``repro.prepare`` (boolean and counting
semirings, centrality; the tropical facade is held in
``test_torch_weighted.py``; ``mesh=`` on CPU meshes in
``test_torch_distributed.py``), its refusals, the device rule, and the
package boundaries: no JAX or ``repro`` import anywhere in
the port, one loop driver, and the core reaching its kernels only
through the registry."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import repro
from repro.graph import generators as jgen
from repro_torch.convert import csr_from_arrays
import repro_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def graphs():
    jg = jgen.barabasi_albert(150, 3, seed=4)
    tg = csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                         n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                         m_pad=jg.m_pad, device="cpu")
    return jg, tg


@pytest.mark.parametrize("opts", [
    dict(use_kernel=False, mode="sparse"),
    dict(use_kernel=True, source_batch=64),
    dict(use_kernel=True, mode="push", fused_steps=-1),
])
def test_facade_matches_repro(graphs, opts):
    jg, tg = graphs
    hj = repro.prepare(jg, **opts)
    ht = repro_torch.prepare(tg, device="cpu", **opts)
    sources = [5, 0, 149, 77]
    rj, rt = hj.apsp(sources), ht.apsp(sources)
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    assert int(rj.sweeps) == rt.sweeps
    np.testing.assert_array_equal(np.asarray(rj.direction_counts),
                                  rt.direction_counts.numpy())
    np.testing.assert_array_equal(hj.sssp(42), ht.sssp(42).numpy())
    assert ht.prepared() is ht.prepared()          # built once


def test_facade_options_object(graphs):
    _, tg = graphs
    opts = repro_torch.SweepOptions(mode="pull", use_kernel=False)
    h = repro_torch.prepare(tg, options=opts, device="cpu")
    assert h.apsp([1, 2]).direction_counts[1] > 0
    with pytest.raises(ValueError, match="not both"):
        repro_torch.prepare(tg, options=opts, device="cpu", mode="push")


@pytest.mark.parametrize("opts", [
    dict(use_kernel=False, mode="sparse"),
    dict(use_kernel=True, source_batch=16),
    dict(use_kernel=True, mode="push", fused_steps=-1),
    dict(mode="pull", use_kernel=False),     # pull: counting takes auto
])
def test_facade_counting_matches_repro(graphs, opts):
    """``apsp(semiring="counting")`` and ``sssp(semiring="counting")``
    reach the counting engine, bit-identical to ``repro``."""
    jg, tg = graphs
    hj = repro.prepare(jg, **opts)
    ht = repro_torch.prepare(tg, device="cpu", **opts)
    sources = [5, 0, 149, 77]
    rj = hj.apsp(sources, semiring="counting")
    rt = ht.apsp(sources, semiring="counting")
    np.testing.assert_array_equal(np.asarray(rj.dist), rt.dist.numpy())
    np.testing.assert_array_equal(np.asarray(rj.sigma), rt.sigma.numpy())
    assert int(rj.sweeps) == rt.sweeps
    if opts.get("mode", "auto") != "pull":   # auto + no kernel: wall clock
        np.testing.assert_array_equal(np.asarray(rj.direction_counts),
                                      rt.direction_counts.numpy())
    np.testing.assert_array_equal(hj.sssp(42, semiring="counting"),
                                  ht.sssp(42, semiring="counting").numpy())


@pytest.mark.parametrize("measures", [
    ("closeness", "harmonic", "eccentricity", "betweenness"),
    ("eccentricity",)])
def test_facade_centrality_matches_repro(graphs, measures):
    jg, tg = graphs
    sources = np.arange(0, 150, 9)
    rj = repro.prepare(jg, use_kernel=True).centrality(sources,
                                                        measures=measures)
    rt = repro_torch.prepare(tg, device="cpu", use_kernel=True).centrality(
        sources, measures=measures)
    np.testing.assert_array_equal(rj.eccentricity, rt.eccentricity)
    assert (rj.radius, rj.diameter, int(rj.sweeps)) == \
        (rt.radius, rt.diameter, rt.sweeps)
    assert float(rj.sigma_checksum) == rt.sigma_checksum
    if "betweenness" in measures:
        np.testing.assert_array_equal(rj.closeness, rt.closeness)
        np.testing.assert_allclose(rt.harmonic, rj.harmonic, rtol=1e-6)
        np.testing.assert_allclose(rt.betweenness, rj.betweenness,
                                   rtol=1e-6, atol=1e-9)
    else:
        assert rt.betweenness is None and rt.closeness is None


def test_unported_routes_raise(graphs):
    _, tg = graphs
    h = repro_torch.prepare(tg, device="cpu")
    with pytest.raises(ValueError, match="unknown semiring"):
        h.apsp([0], semiring="min_label")
    # every route takes mesh= (the sharded executor; a CPU mesh runs them
    # in tests/test_torch_distributed.py): a foreign mesh object raises
    # ValueError before anything is built or written
    calls = [
        lambda: h.apsp([0], mesh=object()),
        lambda: h.apsp([0], checkpoint_dir="ckpt", mesh=object()),
        lambda: h.serve(mesh=object()),
        lambda: h.centrality([0], mesh=object()),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="DeviceMesh"):
            call()
    assert not pathlib.Path("ckpt").exists()
    plan = h.tune(use_hlo=False)
    assert h.tuning is plan and plan.backend == "cpu:cpu"
    tuned = repro_torch.prepare(tg, tuning=plan, device="cpu")
    assert tuned.tuning is plan
    assert torch.equal(tuned.apsp([0]).dist, h.apsp([0]).dist)
    # incremental repair is ported: it needs a dynamic graph, and prepare
    # takes a CSRGraph or a DynamicCSRGraph and nothing else
    with pytest.raises(TypeError, match="static CSRGraph"):
        h.incremental([0])
    with pytest.raises(TypeError, match="CSRGraph or a DynamicCSRGraph"):
        repro_torch.prepare(object(), device="cpu")


def test_prepare_defaults_to_the_card(graphs):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device resolves")
    _, tg = graphs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.prepare(tg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        csr_from_arrays({k: getattr(tg, k).numpy() for k in ARRAYS},
                        n_nodes=tg.n_nodes, n_edges=tg.n_edges,
                        m_pad=tg.m_pad)


def test_build_dir_checkout_and_installed(tmp_path, monkeypatch):
    """Kernels build into the checkout's ``build/``; an installed copy
    builds into the per-user cache instead of its install prefix."""
    from repro_torch.kernels import _build
    assert _build.BUILD_DIR == ROOT / "build" / "repro_torch"
    installed = tmp_path / "lib" / "python3" / "site-packages" / "repro_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir(installed) == tmp_path / "cache" / "repro_torch"


# --------------------------------------------------------------------------
# package boundaries
# --------------------------------------------------------------------------

# the modules each slice added: the boundary tests below must scan them
SLICE_MODULES = (
    "core/engine.py", "core/sweep.py", "kernels/bovm/kernel.py",
    "kernels/bovm/ref.py",
    "core/bovm.py", "core/sovm.py", "core/sssp.py", "core/centrality.py",
    "kernels/counting/__init__.py", "kernels/counting/kernel.py",
    "kernels/counting/ref.py",
    "core/weighted.py", "kernels/tropical/__init__.py",
    "kernels/tropical/kernel.py", "kernels/tropical/ref.py",
    "core/wcc.py", "core/bfs.py", "kernels/bovm/ops.py",
    "graph/dynamic.py", "core/incremental.py",
    "core/distributed.py", "graph/partition.py", "launch/mesh.py",
)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_boundary_tests_scan_every_slice_module():
    files = set(_port_files())
    for rel in SLICE_MODULES:
        assert PORT / rel in files, rel
    cores = {p.name for p in (PORT / "core").rglob("*.py")}
    assert {"bovm.py", "sovm.py", "sssp.py", "centrality.py",
            "weighted.py", "wcc.py", "bfs.py", "incremental.py"} <= cores


def _imports(path: pathlib.Path):
    """Absolute module names a file imports (relative ones resolved)."""
    tree = ast.parse(path.read_text())
    pkg = path.relative_to(ROOT / "src").with_suffix("").parts \
        if ROOT / "src" in path.parents else ()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[: len(pkg) - node.level]
                mod = ".".join(base + ((node.module,) if node.module
                                       else ()))
                yield mod
                for a in node.names:
                    yield f"{mod}.{a.name}"
            else:
                yield node.module


def test_port_imports_no_jax_and_no_repro():
    assert (ROOT / "chip_smoke.py").exists()
    for path in _port_files():
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_one_loop_driver_in_sweep():
    """The only ``while`` loop under repro_torch/core is sweep_loop's."""
    found = []
    for path in sorted((PORT / "core").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    if isinstance(node, ast.While):
                        found.append((path.name, fn.name))
    assert sorted(set(found)) == [("sweep.py", "sweep_loop")]


def test_core_reaches_kernels_through_the_registry():
    from repro_torch.kernels import registry
    assert set(registry.available()) >= {"boolean", "counting", "tropical"}
    for path in sorted((PORT / "core").rglob("*.py")):
        for mod in _imports(path):
            if mod.startswith("repro_torch.kernels"):
                assert mod in ("repro_torch.kernels",
                               "repro_torch.kernels.common",
                               "repro_torch.kernels.registry"), (path, mod)

"""The port's facade against ``repro.prepare``, the routes it does not
port yet, the device rule, and the package boundaries: no JAX or
``repro`` import anywhere in the port, one loop driver, and the core
reaching its kernels only through the registry."""
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


def test_unported_routes_raise(graphs):
    _, tg = graphs
    h = repro_torch.prepare(tg, device="cpu")
    for semiring, item in (("tropical", "item 7"), ("counting", "item 6")):
        with pytest.raises(NotImplementedError, match=item):
            h.apsp([0], semiring=semiring)
    with pytest.raises(ValueError, match="unknown semiring"):
        h.apsp([0], semiring="min_label")
    calls = {
        "item 11": lambda: h.apsp([0], mesh=object()),
        "item 10": lambda: h.apsp([0], checkpoint_dir="ckpt"),
        "item 6": h.centrality,
        "item 8": h.incremental,
        "item 9": h.serve,
        "item 12": h.tune,
    }
    for item, call in calls.items():
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(NotImplementedError, match="item 7"):
        repro_torch.prepare(tg, weights=np.ones(tg.m_pad), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        repro_torch.prepare(tg, tuning=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
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

def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    for path in sorted((PORT / "core").rglob("*.py")):
        for mod in _imports(path):
            if mod.startswith("repro_torch.kernels"):
                assert mod in ("repro_torch.kernels",
                               "repro_torch.kernels.common",
                               "repro_torch.kernels.registry"), (path, mod)

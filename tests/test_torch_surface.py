"""The port's public surface against the JAX package's, module by module,
and the two gaps it closed: ``accum_dtype`` on the reference dense push
and ``Semiring.unreached_mask``.

The walk goes over every module of ``repro`` (``_attic`` aside) and asks,
for each public item, that ``repro_torch`` has it at the same dotted path:

  * the module itself;
  * its public names (defined in the module, or listed in its
    ``__all__``);
  * the parameter names of each public function and class constructor
    (a name re-exported from another module is walked where it is
    defined);
  * the public members of each public class (attributes, methods and
    fields, up its bases in the package).

Items are keyed ``"module"``, ``"module:name"``, ``"module:name(param=)"``
and ``"module:Class.member"``, the module relative to the package.  An
item the port lacks stands in ``ALLOWLIST`` with one of two kinds of
entry:

  * ``(RENAMED, <port name>)``: the port has it under another name.  The
    target must exist; a renamed function's parameters and a renamed
    class's members are held against the target's.
  * ``(NO_COUNTERPART, <reason>)``: a TPU artefact with nothing to port.
    An entry for a module or a name covers everything in it.

An entry goes stale, and fails, when its item has left the JAX package,
when the port has the item now, or when another entry already covers it.
The port may have more than the reference (``device=``, ``generator=``,
``smem_bytes``, ``convert``, ``launch.op_analysis``).
"""
import ast
import functools
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro
import repro_torch
from repro.core import bovm as jbovm
from repro.core import sweep as jsweep
from repro.graph import generators as jgen
from repro_torch.core import bovm as tbovm
from repro_torch.core import sweep as tsweep

RENAMED = "renamed"
NO_COUNTERPART = "no counterpart"

_INTERPRET = ("Pallas interpret mode: the port's wrappers take their plain "
              "versions on CPU tensors and launch the kernel on CUDA ones")
_VMEM = ("prices Pallas VMEM per grid step of every form; the port's "
         "smem_bytes prices one block of the fused kernel, and the "
         "per-sweep kernels size their own tiles at launch")
_MOSAIC = "Mosaic (TPU) compiler settings of a pallas_call"
_DRYRUN = ("reads the TPU dry-run's records (src/repro/_attic/launch/"
           "dryrun.py), which are not ported")

ALLOWLIST = {
    # -- renamed ------------------------------------------------------------
    "core:bfs_level_sync_jax": (RENAMED, "bfs_level_sync_torch"),
    "core.bfs:bfs_level_sync_jax": (RENAMED, "bfs_level_sync_torch"),
    "graph.sampler:sample_hop(key=)": (RENAMED, "generator"),
    "graph.sampler:sample_subgraph(key=)": (RENAMED, "generator"),
    "kernels.common:MXU_ALIGN": (RENAMED, "ALIGN"),
    "kernels.common:VMEM_BUDGET_BYTES": (RENAMED, "SMEM_BUDGET_BYTES"),
    "kernels.common:vmem_limit": (RENAMED, "smem_limit"),
    "kernels.registry:KernelSet(vmem_bytes=)": (RENAMED, "smem_bytes"),
    "kernels.registry:KernelSet.vmem_bytes": (RENAMED, "smem_bytes"),
    "launch.mesh:ICI_BW": (RENAMED, "NVLINK_BW"),
    # -- no counterpart -----------------------------------------------------
    "compat": (NO_COUNTERPART,
               "jax-version shims (shard_map, set_mesh, AxisType); the "
               "port calls torch.distributed itself"),
    "launch.hlo_analysis": (NO_COUNTERPART,
                            "parses compiled HLO text; launch.op_analysis "
                            "prices a callable from its aten ops instead"),
    "launch.roofline:analyze_cell": (NO_COUNTERPART, _DRYRUN),
    "launch.roofline:markdown_table": (NO_COUNTERPART, _DRYRUN),
    "launch.roofline:main": (NO_COUNTERPART, _DRYRUN),
    "launch.mesh:HBM_BYTES": (NO_COUNTERPART,
                              "the TPU v5e's 16 GiB a chip, which no "
                              "module of the package reads"),
    "kernels.common:CompilerParams": (NO_COUNTERPART, _MOSAIC),
    "kernels.common:sweep_compiler_params": (NO_COUNTERPART, _MOSAIC),
    "kernels.common:fused_compiler_params": (NO_COUNTERPART, _MOSAIC),
    "kernels.common:default_interpret": (NO_COUNTERPART, _INTERPRET),
    "kernels.common:push_grid_spec": (NO_COUNTERPART,
                                      "a Pallas grid spec; the CUDA "
                                      "kernels pick their launch shapes"),
    "kernels.common:pull_grid_spec": (NO_COUNTERPART,
                                      "a Pallas grid spec; the CUDA "
                                      "kernels pick their launch shapes"),
    "kernels.common:fused_grid_spec": (NO_COUNTERPART,
                                       "a Pallas grid spec; the CUDA "
                                       "kernels pick their launch shapes"),
    "kernels.common:push_vmem_bytes": (NO_COUNTERPART, _VMEM),
    "kernels.common:pull_vmem_bytes": (NO_COUNTERPART, _VMEM),
    "kernels.common:fused_vmem_bytes": (NO_COUNTERPART, _VMEM),
    "kernels.bovm:vmem_bytes": (NO_COUNTERPART, _VMEM),
    "kernels.counting:vmem_bytes": (NO_COUNTERPART, _VMEM),
    "kernels.tropical:vmem_bytes": (NO_COUNTERPART, _VMEM),
    "core.sweep:boolean_forms(interpret=)": (NO_COUNTERPART, _INTERPRET),
    "core.sweep:counting_forms(interpret=)": (NO_COUNTERPART, _INTERPRET),
    "core.sweep:tropical_forms(interpret=)": (NO_COUNTERPART, _INTERPRET),
    "core.sweep:fused_form(interpret=)": (NO_COUNTERPART, _INTERPRET),
    "core.engine:measure_sweep_costs(interpret=)": (NO_COUNTERPART,
                                                    _INTERPRET),
    "core.centrality:measure_counting_costs(interpret=)": (NO_COUNTERPART,
                                                           _INTERPRET),
    "core.weighted:measure_weighted_costs(interpret=)": (NO_COUNTERPART,
                                                         _INTERPRET),
    "kernels.bovm.kernel:packed_push_sweep(interpret=)": (NO_COUNTERPART,
                                                          _INTERPRET),
    "kernels.bovm.kernel:packed_pull_sweep(interpret=)": (NO_COUNTERPART,
                                                          _INTERPRET),
    "kernels.bovm.kernel:fused_sweep(interpret=)": (NO_COUNTERPART,
                                                    _INTERPRET),
    "kernels.bovm.kernel:fused_boolean_multisweep(interpret=)": (
        NO_COUNTERPART, _INTERPRET),
    "kernels.counting.kernel:fused_counting_sweep(interpret=)": (
        NO_COUNTERPART, _INTERPRET),
    "kernels.counting.kernel:fused_counting_multisweep(interpret=)": (
        NO_COUNTERPART, _INTERPRET),
    "kernels.tropical.kernel:fused_minplus_sweep(interpret=)": (
        NO_COUNTERPART, _INTERPRET),
    "kernels.tropical.kernel:fused_minplus_multisweep(interpret=)": (
        NO_COUNTERPART, _INTERPRET),
    "kernels.tropical.kernel:sparse_relax_sweep(interpret=)": (
        NO_COUNTERPART, _INTERPRET),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------------------
# the walk
# --------------------------------------------------------------------------

def _module_names(pkg, prefix: str = "") -> list:
    """The package's modules relative to it ("" for the package), without
    ``_attic`` (which is never imported)."""
    out = [prefix.rstrip(".")]
    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name == "_attic":
            continue
        if m.ispkg:
            sub = importlib.import_module(f"{pkg.__name__}.{m.name}")
            out += _module_names(sub, f"{prefix}{m.name}.")
        else:
            out.append(prefix + m.name)
    return sorted(out)


JAX_MODULES = _module_names(repro)


def _module(pkg: str, rel: str):
    return importlib.import_module(pkg + ("." + rel if rel else ""))


def _defined_names(mod) -> set:
    """Public names bound at the module's top level (also inside its
    top-level ``if`` / ``try`` blocks), plus its ``__all__``."""
    names = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                names.add(node.target.id)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                for h in getattr(node, "handlers", ()):
                    visit(h.body)
                visit(node.orelse)

    visit(ast.parse(inspect.getsource(mod)).body)
    names = {n for n in names if not n.startswith("_")}
    return names | set(getattr(mod, "__all__", ()))


def _params(obj) -> list:
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return []
    return [p for p in sig.parameters if p != "self"]


def _members(cls) -> set:
    out = set(getattr(cls, "__dataclass_fields__", ()))
    out |= set(getattr(cls, "_fields", ()))
    for k in cls.__mro__:
        if (k.__module__ or "").split(".")[0] in ("repro", "repro_torch"):
            out |= set(vars(k)) | set(getattr(k, "__annotations__", {}))
    return {n for n in out if not n.startswith("_")}


def module_items(rel: str) -> list:
    """Every public item of the JAX package's module ``rel``."""
    mod = _module("repro", rel)
    items = [rel]
    for n in sorted(_defined_names(mod)):
        if not hasattr(mod, n):
            continue
        obj = getattr(mod, n)
        items.append(f"{rel}:{n}")
        if getattr(obj, "__module__", None) != mod.__name__:
            continue      # walked where it is defined (or not ours)
        if inspect.isclass(obj) or callable(obj):
            items += [f"{rel}:{n}({p}=)" for p in _params(obj)]
        if inspect.isclass(obj):
            items += [f"{rel}:{n}.{m}" for m in sorted(_members(obj))]
    return items


@functools.lru_cache(maxsize=None)
def all_jax_items() -> frozenset:
    return frozenset(i for rel in JAX_MODULES for i in module_items(rel))


def _parse(key: str):
    """``key`` -> (module, name, param, member); absent parts are None."""
    rel, _, rest = key.partition(":")
    if not rest:
        return rel, None, None, None
    if rest.endswith("=)"):
        name, _, param = rest[:-2].partition("(")
        return rel, name, param, None
    name, _, member = rest.partition(".")
    return rel, name, None, member or None


def port_has(key: str, allowlist=ALLOWLIST) -> bool:
    """Does the port hold ``key``, read through ``allowlist``'s renames?"""
    rel, name, param, member = _parse(key)

    def renamed(k, default):
        kind, target = allowlist.get(k, (None, None))
        return target if kind == RENAMED else default

    try:
        obj = _module("repro_torch", rel)
    except ModuleNotFoundError:
        return False
    if name is None:
        return True
    name = renamed(f"{rel}:{name}", name)
    if not hasattr(obj, name):
        return False
    obj = getattr(obj, name)
    if param is not None:
        return renamed(key, param) in _params(obj)
    if member is not None:
        member = renamed(key, member)
        return hasattr(obj, member) or (inspect.isclass(obj) and
                                        member in _members(obj))
    return True


def _ancestors(key: str) -> list:
    """The keys whose allowlist entry would cover ``key``: the key, its
    name, its module."""
    rel, name, _, _ = _parse(key)
    out = [key]
    if name is not None:
        out += [f"{rel}:{name}", rel]
    return list(dict.fromkeys(out))


def uncovered(key: str, allowlist=ALLOWLIST) -> bool:
    """A JAX item with no counterpart in the port and no entry for it."""
    if any(allowlist.get(a, ("",))[0] == NO_COUNTERPART
           for a in _ancestors(key)):
        return False
    return not port_has(key, allowlist)


def stale(key: str, allowlist=ALLOWLIST, jax_items=None):
    """Why the entry for ``key`` is stale, or None if it is not."""
    kind, what = allowlist[key]
    if kind not in (RENAMED, NO_COUNTERPART) or not what:
        return f"{key}: an entry is (RENAMED, name) or " \
               f"(NO_COUNTERPART, reason)"
    if key not in (all_jax_items() if jax_items is None else jax_items):
        return f"{key}: no longer in the JAX package"
    if any(a in allowlist and allowlist[a][0] == NO_COUNTERPART
           for a in _ancestors(key)[1:]):
        return f"{key}: already covered by an entry above it"
    if port_has(key, {k: v for k, v in allowlist.items() if k != key}):
        return f"{key}: the port has it now"
    if kind == RENAMED and not port_has(key, allowlist):
        return f"{key}: the port has no {what!r}"
    return None


# --------------------------------------------------------------------------
# the surface
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rel", JAX_MODULES, ids=lambda r: r or "repro")
def test_module_has_its_counterpart(rel):
    missing = [k for k in module_items(rel) if uncovered(k)]
    assert not missing, (
        f"repro_torch lacks these items of repro.{rel or '__init__'}; port "
        f"them or add an ALLOWLIST entry with its reason: {missing}")


@pytest.mark.parametrize("rel", [r for r in JAX_MODULES
                                 if hasattr(_module("repro", r), "__all__")],
                         ids=lambda r: r or "repro")
def test_module_all_holds_the_reference_names(rel):
    """Where a JAX module lists ``__all__``, the port's lists every name of
    it that the port has (renames read through)."""
    theirs = _module("repro", rel).__all__
    ours = getattr(_module("repro_torch", rel), "__all__", None)
    assert ours is not None, f"repro_torch.{rel} has no __all__"
    want = []
    for n in theirs:
        key = f"{rel}:{n}"
        if uncovered(key) or not port_has(key):
            continue
        kind, target = ALLOWLIST.get(key, (None, None))
        want.append(target if kind == RENAMED else n)
    assert not set(want) - set(ours), sorted(set(want) - set(ours))


PUBLIC_SURFACE = [
    "CSRGraph",
    "DawnGraph",
    "DynamicCSRGraph",
    "IncrementalSSSP",
    "IncrementalState",
    "RepairResult",
    "SEMIRING_NAMES",
    "SweepOptions",
    "prepare",
    "repair",
    "sssp_state",
]


def test_public_surface_matches_snapshot_and_reference():
    """The port's counterpart of ``tests/test_api_surface.py``: the
    facade's ``__all__`` is frozen, and it is the JAX package's."""
    assert sorted(repro_torch.__all__) == PUBLIC_SURFACE
    assert sorted(repro_torch.__all__) == sorted(repro.__all__)
    for name in repro_torch.__all__:
        assert hasattr(repro_torch, name), f"__all__ exports missing {name}"


@pytest.mark.parametrize("key", sorted(ALLOWLIST))
def test_allowlist_entry_is_live(key):
    reason = stale(key)
    assert reason is None, reason


def test_stale_entries_are_caught():
    """The checks above fail on an entry that has rotted."""
    items = frozenset({"core.sweep:BOOLEAN", "core.sweep:Semiring",
                       "core.sweep:Semiring.name", "core.bfs:gone"})
    fake = {
        "core.sweep:BOOLEAN": (NO_COUNTERPART, "the port has it"),
        "core.sweep:Semiring.name": (NO_COUNTERPART, "covered below"),
        "core.sweep:Semiring": (NO_COUNTERPART, "covers its members"),
        "core.bfs:gone": (NO_COUNTERPART, "left the JAX package"),
        "core.bfs:missing": (RENAMED, "no_such_name"),
    }
    assert "the port has it now" in stale("core.sweep:BOOLEAN", fake, items)
    assert "covered by an entry" in stale("core.sweep:Semiring.name", fake,
                                          items)
    assert "no longer in the JAX package" in stale("core.bfs:missing", fake,
                                                   items)
    items |= {"core.bfs:missing"}
    assert "has no 'no_such_name'" in stale("core.bfs:missing", fake, items)
    assert "the port has it now" in stale("core.sweep:Semiring", fake, items)
    assert stale("core.bfs:gone", fake, items) is None
    # a missing item with no entry is reported
    assert uncovered("core.bfs:gone", {})
    assert not uncovered("core.bfs:bfs_level_sync_jax")
    assert uncovered("core.bfs:bfs_level_sync_jax", {})


def test_renamed_function_keeps_its_parameters():
    """A rename reads through to the target's parameters."""
    for p in ("g", "source", "max_steps"):
        assert f"core.bfs:bfs_level_sync_jax({p}=)" in all_jax_items()
        assert port_has(f"core.bfs:bfs_level_sync_jax({p}=)")
    assert not port_has("core.bfs:bfs_level_sync_jax(key=)")


# --------------------------------------------------------------------------
# accum_dtype on the reference dense push
# --------------------------------------------------------------------------

ACCUM = [("float32", jnp.float32, torch.float32),
         ("float16", jnp.float16, torch.float16),
         ("bfloat16", jnp.bfloat16, torch.bfloat16),
         ("int32", jnp.int32, torch.int32)]


def _in_star(leaves: int):
    """Node 0 -> leaves 1..L -> node L+1: the centre's count of frontier
    in-neighbours at sweep 2 is L."""
    n = leaves + 2
    adj = np.zeros((n, n), np.int8)
    adj[0, 1:leaves + 1] = 1
    adj[1:leaves + 1, n - 1] = 1
    return adj


@pytest.mark.parametrize("name,jdt,tdt", ACCUM, ids=[a[0] for a in ACCUM])
def test_bovm_sweep_accum_dtype_matches_jax(name, jdt, tdt):
    rng = np.random.default_rng(11)
    adj = (rng.random((96, 96)) < 0.2).astype(np.int8)
    f = rng.random((5, 96)) < 0.3
    v = rng.random((5, 96)) < 0.4
    want = np.asarray(jbovm.bovm_sweep(jnp.asarray(adj), jnp.asarray(f),
                                       jnp.asarray(v), accum_dtype=jdt))
    for acc in (tdt, name):
        got = tbovm.bovm_sweep(torch.from_numpy(adj), torch.from_numpy(f),
                               torch.from_numpy(v), accum_dtype=acc)
        np.testing.assert_array_equal(got.numpy(), want)
    # counts past int8's range and bfloat16's exact integers
    for leaves in (128, 256, 300):
        star = _in_star(leaves)
        front = np.zeros((1, leaves + 2), bool)
        front[0, 1:leaves + 1] = True
        none = np.zeros_like(front)
        want = np.asarray(jbovm.bovm_sweep(jnp.asarray(star),
                                           jnp.asarray(front),
                                           jnp.asarray(none),
                                           accum_dtype=jdt))
        got = tbovm.bovm_sweep(torch.from_numpy(star),
                               torch.from_numpy(front),
                               torch.from_numpy(none), accum_dtype=tdt)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want[0, -1]


@pytest.mark.parametrize("name,jdt,tdt", ACCUM, ids=[a[0] for a in ACCUM])
def test_bovm_msbfs_accum_dtype_matches_jax(name, jdt, tdt):
    jg = jgen.rmat(7, 6, directed=True, seed=4)
    adj = np.array(jg.to_dense())
    sources = np.array([0, 3, 77, 127], np.int32)
    sj = jbovm.bovm_msbfs(jnp.asarray(adj), jnp.asarray(sources),
                          accum_dtype=jdt)
    for acc in (tdt, name):
        st = tbovm.bovm_msbfs(torch.from_numpy(adj), sources,
                              accum_dtype=acc)
        np.testing.assert_array_equal(st.dist.numpy(), np.asarray(sj.dist))
        assert (st.step, st.done) == (int(sj.step), bool(sj.done))
        assert np.float32(st.edges_touched) == np.float32(sj.edges_touched)


@pytest.mark.parametrize("name,jdt,tdt", ACCUM, ids=[a[0] for a in ACCUM])
def test_boolean_forms_accum_dtype_matches_jax(name, jdt, tdt):
    """The dense push of ``boolean_forms`` through ``sweep_loop``: dist,
    sweeps and edges_touched, on a graph with a 300-leaf in-star."""
    adj = _in_star(300)
    adj[5, 17] = adj[17, 40] = 1
    n = adj.shape[0]
    sources = np.array([0, 5], np.int32)
    f0 = np.zeros((2, n), np.int8)
    f0[np.arange(2), sources] = 1
    d0 = np.where(f0 != 0, 0, -1).astype(np.int32)
    deg = adj.sum(axis=1).astype(np.float32)
    jpush = jsweep.boolean_forms(
        jnp.asarray(adj), jnp.zeros((1, 1), jnp.uint32),
        jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.int32), n_pad=n, s=2,
        accum_dtype=jdt)[0]
    sj = jsweep.sweep_loop((jpush,), jsweep.make_state(
        jnp.asarray(f0), jnp.asarray(d0), n_forms=1), max_steps=n,
        deg=jnp.asarray(deg))
    dummy = torch.zeros(1, dtype=torch.int32)
    tpush = tsweep.boolean_forms(torch.from_numpy(adj), None, dummy, dummy,
                                 n_pad=n, s=2, accum_dtype=tdt)[0]
    st = tsweep.sweep_loop((tpush,), tsweep.make_state(
        torch.from_numpy(f0), torch.from_numpy(d0), n_forms=1),
        max_steps=n, deg=torch.from_numpy(deg))
    np.testing.assert_array_equal(st.dist.numpy(), np.asarray(sj.dist))
    assert st.dist[0, -1] == 2
    assert st.sweeps == int(sj.sweeps)
    assert np.float32(st.edges_touched) == np.float32(sj.edges_touched)


@pytest.mark.parametrize("leaves", [128, 256])
def test_narrow_integer_accum_wraps_in_jax_and_is_refused(leaves):
    """JAX's int8 count of the in-star's centre wraps (128 -> -128,
    256 -> 0), so the node is missed; the port refuses the dtype."""
    star = _in_star(leaves)
    front = np.zeros((1, leaves + 2), bool)
    front[0, 1:leaves + 1] = True
    none = np.zeros_like(front)
    hits = np.asarray(jbovm.bovm_sweep(jnp.asarray(star), jnp.asarray(front),
                                       jnp.asarray(none),
                                       accum_dtype=jnp.int8))
    assert not hits[0, -1]                      # the reference misses it
    sj = jbovm.bovm_msbfs(jnp.asarray(star), jnp.asarray([0], jnp.int32),
                          accum_dtype=jnp.int8)
    assert int(sj.dist[0, -1]) == -1            # never reached
    for acc in (torch.int8, torch.uint8, torch.int16, "int8", "int16"):
        with pytest.raises(ValueError, match="wraps"):
            tbovm.bovm_sweep(torch.from_numpy(star), torch.from_numpy(front),
                             torch.from_numpy(none), accum_dtype=acc)
        with pytest.raises(ValueError, match="wraps"):
            tbovm.bovm_msbfs(torch.from_numpy(star), [0], accum_dtype=acc)
    with pytest.raises(ValueError, match="wraps"):
        tsweep.boolean_forms(None, None, torch.zeros(1), torch.zeros(1),
                             n_pad=4, s=1, accum_dtype=torch.int8)
    with pytest.raises(ValueError, match="one of"):
        tsweep.resolve_accum_dtype(torch.float64)


# --------------------------------------------------------------------------
# Semiring.unreached_mask
# --------------------------------------------------------------------------

@pytest.mark.parametrize("semiring", ["boolean", "counting", "tropical"])
def test_unreached_mask_matches_jax(semiring):
    rng = np.random.default_rng(2)
    if semiring == "tropical":
        dist = np.where(rng.random((6, 40)) < 0.4, np.inf,
                        rng.uniform(0, 9, (6, 40))).astype(np.float32)
    else:
        dist = np.where(rng.random((6, 40)) < 0.4, -1,
                        rng.integers(0, 9, (6, 40))).astype(np.int32)
    want = np.asarray(jsweep.SEMIRINGS[semiring].unreached_mask(
        jnp.asarray(dist)))
    got = tsweep.SEMIRINGS[semiring].unreached_mask(torch.from_numpy(dist))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()

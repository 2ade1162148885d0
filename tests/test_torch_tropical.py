"""The port's tropical (min,+) kernels and forms against the JAX package on
the CPU: the three kernels' plain versions (through the port's wrappers,
on CPU tensors) against the Pallas kernels in interpret mode, the
indexes K7 / K8 and K9 read against numpy, the registry set and its
fused gate, the dense form against the sparse form,
``minplus_candidates`` and the weighted branch of ``derive_parents``.
Every comparison is bit-identical: a candidate is one f32 add and the
reduction is a min, which is exact in any order."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from oracles import adversarial_families
from repro.core import sweep as jsweep
from repro.graph.csr import CSRGraph as JCSR
from repro.kernels.tropical import kernel as jkern
from repro_torch.convert import csr_from_arrays, lane_weights_from_array
from repro_torch.core import sweep as tsweep
from repro_torch.kernels import common, registry
from repro_torch.kernels import tropical as tkern

ARRAYS = ("indptr", "indices", "src", "dst", "indptr_t", "indices_t")
FAMILIES = {name: (src, dst, n) for name, src, dst, n in
            adversarial_families()}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _same(want, got):
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _tropical_state(rng, s, n, *, density=0.1):
    """The random tropical state of the JAX kernel tests: a ~3% weight
    matrix in [0.5, 4.0), ~30% finite distances, a random frontier."""
    w = np.full((n, n), np.inf, np.float32)
    mask = rng.random((n, n)) < 0.03
    w[mask] = rng.uniform(0.5, 4.0, mask.sum())
    dist = np.where(rng.random((s, n)) < 0.3,
                    rng.uniform(0.0, 10.0, (s, n)), np.inf).astype(np.float32)
    f = (rng.random((s, n)) < density).astype(np.int8)
    fdist = np.where(f != 0, dist, np.inf).astype(np.float32)
    finite = w[np.isfinite(w)]
    w_min = np.float32(finite.min() if finite.size else np.inf)
    return f, fdist, w, dist, w_min


def _carry(jg):
    return csr_from_arrays({k: np.asarray(getattr(jg, k)) for k in ARRAYS},
                           n_nodes=jg.n_nodes, n_edges=jg.n_edges,
                           m_pad=jg.m_pad, device="cpu")


# --------------------------------------------------------------------------
# K7: the dense min-plus push
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,n,bs,bn,bk", [
    (64, 256, 64, 128, 128),
    (8, 128, 8, 128, 128),
    (16, 384, 16, 128, 128),
])
def test_minplus_sweep_matches_pallas(s, n, bs, bn, bk):
    rng = np.random.default_rng(s * n + 1)
    _, fdist, w, dist, w_min = _tropical_state(rng, s, n)
    want = jkern.fused_minplus_sweep(jnp.asarray(fdist), jnp.asarray(w),
                                     jnp.asarray(dist), w_min, bs=bs, bn=bn,
                                     bk=bk, interpret=True)
    got = tkern.fused_minplus_sweep(_t(fdist), _t(w), _t(dist),
                                    float(w_min), bs=bs, bn=bn, bk=bk)
    _same(want, got)
    assert tkern.fused_minplus_sweep.launches == 0       # CPU: no launch


def test_minplus_settled_skip_matches_pallas():
    """The settled-bound tile skip: an output tile whose distances all sit
    under min_frontier + w_min is skipped, half the k-blocks are dead,
    and the result still equals the Pallas kernel's."""
    rng = np.random.default_rng(7)
    s, n = 64, 256
    w = np.full((n, n), np.inf, np.float32)
    mask = rng.random((n, n)) < 0.05
    w[mask] = rng.uniform(1.0, 2.0, mask.sum())
    dist = np.full((s, n), np.inf, np.float32)
    dist[:, :128] = rng.uniform(0.0, 0.5, (s, 128))     # settled out-tile
    f = np.zeros((s, n), np.int8)
    f[:, :64] = rng.random((s, 64)) < 0.2               # dead k-block
    fdist = np.where(f != 0, dist, np.inf).astype(np.float32)
    w_min = np.float32(w[np.isfinite(w)].min())
    want = jkern.fused_minplus_sweep(jnp.asarray(fdist), jnp.asarray(w),
                                     jnp.asarray(dist), w_min, bs=64,
                                     bn=128, bk=128, interpret=True)
    got = tkern.fused_minplus_sweep(_t(fdist), _t(w), _t(dist),
                                    torch.tensor(w_min), bs=64)
    _same(want, got)
    # the tables the wrapper builds: the settled tile and the dead
    # k-block are both skipped, and the skip changes nothing
    bound = _t(fdist).amin(dim=1, keepdim=True) + float(w_min)
    o_occ = common.block_any(_t(dist) > bound, 1, s, 2, 128)
    f_occ = common.block_any(torch.isfinite(_t(fdist)), 1, s, 2, 128)
    assert o_occ.tolist() == [[False, True]]
    assert f_occ.tolist() == [[True, False]]
    _same(got, tkern.minplus_sweep_ref(_t(fdist), _t(w), _t(dist)))


def test_minplus_no_edges_skips_every_tile():
    """w_min = +inf (no edges): every bound is +inf, every tile is
    skipped and nothing improves."""
    s, n = 8, 128
    fdist = torch.zeros((s, n))
    dist = torch.full((s, n), float("inf"))
    w = torch.full((n, n), float("inf"))
    new, d = tkern.fused_minplus_sweep(fdist, w, dist, float("inf"), bs=8)
    assert not new.any() and torch.equal(d, dist)


# --------------------------------------------------------------------------
# K9: the edge-parallel sparse relax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_index", [False, True])
@pytest.mark.parametrize("s,n_pad,eb", [(8, 128, 128), (16, 256, 128),
                                        (32, 256, 256)])
def test_sparse_relax_matches_pallas(s, n_pad, eb, with_index):
    """K9's plain version against the Pallas kernel; on the CPU the
    wrapper reads no in-lane index, so handing it one (checked, then
    ignored) changes nothing."""
    rng = np.random.default_rng(s + n_pad)
    n = n_pad - 1                                     # room for the sentinel
    m = 4 * n
    m_pad = ((m + eb - 1) // eb) * eb
    src = np.full(m_pad, n, np.int32)
    dst = np.full(m_pad, n, np.int32)
    w = np.full(m_pad, np.inf, np.float32)
    src[:m] = rng.integers(0, n, m)
    dst[:m] = rng.integers(0, n, m)
    w[:m] = rng.uniform(0.5, 4.0, m)
    f = (rng.random((s, n_pad)) < 0.1).astype(np.int8)
    dist = np.where(rng.random((s, n_pad)) < 0.4,
                    rng.uniform(0.0, 8.0, (s, n_pad)),
                    np.inf).astype(np.float32)
    args = (f, dist, src, dst, w)
    want = jkern.sparse_relax_sweep(*map(jnp.asarray, args), eb=eb,
                                    interpret=True)
    index = tkern.in_lanes(_t(src), _t(dst), _t(w), n_pad) \
        if with_index else None
    got = tkern.sparse_relax_sweep(*map(_t, args), eb=eb, index=index)
    _same(want, got)
    assert tkern.sparse_relax_sweep.launches == 0
    assert tkern.in_lanes.launches == 0                  # CPU: no launch
    with pytest.raises(ValueError, match="multiple of eb"):
        tkern.sparse_relax_sweep(*map(_t, args), eb=3 * m_pad, index=index)
    if with_index:
        with pytest.raises(ValueError, match="offsets"):
            tkern.sparse_relax_sweep(*map(_t, args), eb=eb, index=(
                tkern.in_lanes(_t(src), _t(dst), _t(w), 2 * n_pad)))
        with pytest.raises(ValueError, match="w must be torch.float32"):
            tkern.sparse_relax_sweep(*map(_t, args), eb=eb, index=(
                index._replace(w=index.w.double())))


# --------------------------------------------------------------------------
# the in-lane index K9 reads
# --------------------------------------------------------------------------

def _lane_families():
    """The adversarial families (multi-edges, self-loops, a fan-in hub,
    isolated nodes), plus a hub of in-degree 700 among isolated nodes."""
    fams = dict(FAMILIES)
    n = 900
    fams["hub_in"] = (np.arange(1, 701, dtype=np.int32),
                      np.full(700, 5, np.int32), n)
    return fams


LANE_FAMILIES = _lane_families()


def _numpy_csc(src, dst, w, n_pad):
    """The CSC of the lanes below +inf weight, each target's lanes sorted
    by (source, weight bits): (offsets, src, w)."""
    keep = w < np.inf
    src, dst, w = src[keep], dst[keep], w[keep]
    order = np.lexsort((w.view(np.int32), src, dst))
    counts = np.bincount(dst, minlength=n_pad)
    return np.r_[0, np.cumsum(counts)], src[order], w[order]


def _numpy_pieces(off, hub):
    """Per target with more than ``hub`` in-lanes, its lanes cut into
    runs of ``hub``: (first piece of each target, (start, end) pairs)."""
    first, pieces = [0], []
    for lo, hi in zip(off[:-1], off[1:]):
        if hi - lo > hub:
            pieces += [(a, min(a + hub, hi)) for a in range(lo, hi, hub)]
        first.append(len(pieces))
    return np.asarray(first), np.asarray(pieces).reshape(-1, 2)


@pytest.mark.parametrize("hub", [3, 256])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("family", sorted(LANE_FAMILIES))
def test_in_lanes_is_the_csc_of_the_lanes(monkeypatch, family, shuffle, hub):
    """The plain in-lane index against a numpy CSC of the padded CSR
    lanes: every lane below +inf weight (zero weights included, the
    sentinel-padded lanes left out) under its target, and none else;
    isolated targets list none; a target of more than ``hub`` in-lanes
    cut into pieces of ``hub`` (``HUB_LANES``).  Lanes in random order
    give the same index up to the order within a target."""
    monkeypatch.setattr(tkern.kernel, "HUB_LANES", hub)
    src, dst, n = LANE_FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    n_pad = jg.n_padded()
    rng = np.random.default_rng(n + len(family))
    lsrc = np.asarray(jg.src).astype(np.int32)
    ldst = np.asarray(jg.dst).astype(np.int32)
    w = np.full(jg.m_pad, np.inf, np.float32)
    w[: jg.n_edges] = rng.integers(0, 9, jg.n_edges) / 4   # zeros, ties
    if shuffle:
        perm = rng.permutation(jg.m_pad)
        lsrc, ldst, w = lsrc[perm], ldst[perm], w[perm]
    idx = tkern.in_lanes(_t(lsrc), _t(ldst), _t(w), n_pad)
    assert idx.offsets.dtype == idx.src.dtype == torch.int32
    assert idx.w.dtype == torch.float32
    off, want_src, want_w = _numpy_csc(lsrc, ldst, w, n_pad)
    np.testing.assert_array_equal(idx.offsets.numpy(), off)
    first, pieces = _numpy_pieces(off, hub)
    assert idx.hub_first.dtype == idx.pieces.dtype == torch.int32
    np.testing.assert_array_equal(idx.hub_first.numpy(), first)
    np.testing.assert_array_equal(idx.pieces.numpy(), pieces)
    assert int(idx.offsets[-1]) == jg.n_edges
    got = tkern.in_lanes_sorted(idx)
    np.testing.assert_array_equal(got.src.numpy(), want_src)
    np.testing.assert_array_equal(got.w.numpy(), want_w)
    if not shuffle:                   # the plain build keeps lane order
        np.testing.assert_array_equal(
            idx.src.numpy(), lsrc[: jg.n_edges][np.argsort(
                ldst[: jg.n_edges], kind="stable")])
    assert tkern.in_lanes.launches == 0


def test_in_lanes_rejects_ids_outside_the_state(monkeypatch):
    src = torch.tensor([0, 1, 2, 300], dtype=torch.int32)
    dst = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    w = torch.tensor([1.0, 2.0, 3.0, 4.0])
    with pytest.raises(ValueError, match="outside"):
        tkern.in_lanes(src, dst, w, 256)
    # a padded lane (+inf) may carry any id: it is left out
    w[3] = float("inf")
    idx = tkern.in_lanes(src, dst, w, 256)
    assert int(idx.offsets[-1]) == 3
    with pytest.raises(ValueError, match="lanes: shapes"):
        tkern.in_lanes(src, dst[:3], w, 256)
    monkeypatch.setattr(tkern.kernel, "HUB_LANES", 0)
    with pytest.raises(ValueError, match="at least one lane"):
        tkern.in_lanes(src, dst, w, 256)


# --------------------------------------------------------------------------
# K8: fused multi-sweep
# --------------------------------------------------------------------------

def _fused_start(seed=17, n=256, s=64):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.03
    w = np.where(mask, rng.integers(1, 8, (n, n)).astype(np.float32),
                 np.inf).astype(np.float32)
    np.fill_diagonal(w, np.inf)
    dist = np.full((s, n), np.inf, np.float32)
    dist[np.arange(s), np.arange(s)] = 0.0
    f = (dist == 0).astype(np.int8)
    return f, w, dist


@pytest.mark.parametrize("n_run", [0, 6, 40])
def test_fused_minplus_multisweep_matches_pallas(n_run):
    """The n = 256, s = 64 state of the JAX test: n_run 0 (inert), 6 (not
    converging) and 40 (converges inside the block)."""
    f, w, dist = _fused_start()
    kw = dict(bs=64, max_sweeps=max(n_run, 1))
    want = jkern.fused_minplus_multisweep(
        jnp.asarray(f), jnp.asarray(w), jnp.asarray(dist), 0, n_run,
        interpret=True, **kw)
    got = tkern.fused_minplus_multisweep(_t(f), _t(w), _t(dist), 0, n_run,
                                         **kw)
    _same(want[:2], got[:2])
    assert int(want[2]) == int(got[2])
    assert bool(want[3]) == bool(got[3])
    assert tkern.fused_minplus_multisweep.launches == 0
    if n_run == 0:
        assert int(got[2]) == 0 and not bool(got[3]) and not got[0].any()
    if n_run == 6:
        assert int(got[2]) == 6 and not bool(got[3])
    if n_run == 40:
        assert bool(got[3]) and 0 < int(got[2]) < n_run


# --------------------------------------------------------------------------
# the live-word index K7 reads
# --------------------------------------------------------------------------

def _index_families():
    """The adversarial families, plus a hub row beside isolated nodes: node
    0 points at every fourth node and nothing else has an edge."""
    fams = dict(FAMILIES)
    n = 300
    spokes = np.arange(4, n, 4, dtype=np.int32)
    fams["hub_isolated"] = (np.zeros(spokes.size, np.int32), spokes, n)
    return fams


INDEX_FAMILIES = _index_families()


@pytest.mark.parametrize("family", sorted(INDEX_FAMILIES))
def test_index_marks_exactly_the_finite_words(family):
    """The plain index build marks exactly the 16-byte words (4 columns)
    of each weight-matrix row that hold a finite weight (one of the row's
    edges), in ascending order; isolated rows list none.  ``work_items``
    bounds the chunks of every row."""
    src, dst, n = INDEX_FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    n_pad = jg.n_padded()
    lsrc = np.asarray(jg.src)[: jg.n_edges].astype(np.int64)
    ldst = np.asarray(jg.dst)[: jg.n_edges].astype(np.int64)
    w = np.full((n_pad, n_pad), np.inf, np.float32)
    w[lsrc, ldst] = np.random.default_rng(n).uniform(0.0, 4.0, lsrc.size)
    idx = tkern.finite_words(_t(w))
    rows, words = np.divmod(np.unique(lsrc * (n_pad // 4) + ldst // 4),
                            n_pad // 4)
    counts = np.bincount(rows, minlength=n_pad)
    np.testing.assert_array_equal(idx.offsets.numpy(),
                                  np.r_[0, np.cumsum(counts)])
    np.testing.assert_array_equal(idx.words.numpy(), words)
    assert idx.offsets.dtype == idx.words.dtype == torch.int32
    assert idx.rows_live == int((counts > 0).sum())
    assert tkern.finite_words.launches == 0               # CPU: no launch
    for chunk in (1, 3, 32):
        assert int(((counts + chunk - 1) // chunk).sum()) <= \
            idx.work_items(chunk)


def test_minplus_sweep_same_with_and_without_index():
    """On the CPU the K7 wrapper takes its plain version, which reads no
    index: passing the live-word index changes nothing, and neither does
    the dense kernel form, which hands it on."""
    rng = np.random.default_rng(11)
    f, fdist, w, dist, w_min = _tropical_state(rng, 16, 256)
    wt = _t(w)
    idx = tkern.finite_words(wt)
    want = tkern.fused_minplus_sweep(_t(fdist), wt, _t(dist), w_min, bs=8)
    got = tkern.fused_minplus_sweep(_t(fdist), wt, _t(dist), w_min, bs=8,
                                    index=idx)
    _same(tuple(x.numpy() for x in want), got)
    src = torch.zeros(128, dtype=torch.int32)
    wl = torch.full((128,), float(w_min))           # the same w_min
    dense, _ = tsweep.tropical_forms(wt, src, src, wl, n_pad=256,
                                     use_kernel=True, windex=idx)
    p = torch.zeros(1, dtype=torch.int32)
    got = dense(_t(f), _t(dist), p, 1)
    ref = tkern.fused_minplus_sweep(_t(fdist), wt, _t(dist), w_min,
                                    bs=16)
    assert ref[0].any()
    _same(tuple(x.numpy() for x in ref), got[:2])


def test_wrappers_validate_shapes_and_tiles():
    zf = torch.zeros((8, 128))
    z8 = torch.zeros((8, 128), dtype=torch.int8)
    w = torch.zeros((128, 128))
    with pytest.raises(ValueError, match="shapes"):
        tkern.fused_minplus_sweep(zf, w[:64], zf, 1.0, bs=8)
    with pytest.raises(ValueError, match="tiles do not divide"):
        tkern.fused_minplus_sweep(zf, w, zf, 1.0, bs=16)
    with pytest.raises(ValueError, match="tiles do not divide"):
        tkern.fused_minplus_multisweep(z8, w, zf, 0, 1, bs=16)
    with pytest.raises(ValueError, match="n_run"):
        tkern.fused_minplus_multisweep(z8, w, zf, 0, 3, bs=8, max_sweeps=2)
    with pytest.raises(ValueError, match="shapes"):
        tkern.fused_minplus_multisweep(z8, w[:64], zf, 0, 1, bs=8)


# --------------------------------------------------------------------------
# the registry set and the fused gate
# --------------------------------------------------------------------------

def test_tropical_registry_and_fused_gate():
    ks = registry.get("tropical")
    assert ks.forms == {"dense": tkern.fused_minplus_sweep,
                        "sparse": tkern.sparse_relax_sweep}
    assert ks.fused_forms == {"dense": tkern.fused_minplus_multisweep}
    # unlike the JAX package, the sparse relax dispatches on the card
    assert ks.interpret_only == frozenset()
    assert ks.dispatchable("sparse", interpret=False)
    # one K8 block holds only its 32 x 32 transpose tile and 32 row
    # masks, at any n_pad (the state and the work list live in global
    # memory): the gate admits every n_pad, the full width the JAX
    # whole-operand VMEM gate refuses and far past it
    assert ks.smem_bytes(form="fused", n=65_664) == \
        ks.smem_bytes(form="fused", n=1 << 24) == \
        tkern.kernel.FUSED_TILE_BYTES == 4_352 <= common.SMEM_BUDGET_BYTES
    assert ks.operand_index is tkern.finite_words
    assert ks.lane_index is tkern.in_lanes
    kw = dict(max_steps=9, use_kernel=True, bs=128)
    assert tsweep.resolve_fused_steps("tropical", "dense", fused_steps=-1,
                                      n_pad=65_664, **kw) == 9
    assert tsweep.resolve_fused_steps("tropical", "dense", fused_steps=-1,
                                      n_pad=1 << 24, **kw) == 9
    assert tsweep.resolve_fused_steps("tropical", "dense", fused_steps=4,
                                      n_pad=65_664, **kw) == 4
    assert tsweep.resolve_fused_steps("tropical", "sparse", fused_steps=-1,
                                      n_pad=1152, **kw) is None
    assert tsweep.resolve_fused_steps("tropical", "dense", fused_steps=4,
                                      n_pad=1152, budget=1024, **kw) is None
    with pytest.raises(ValueError, match="only the fused form"):
        ks.smem_bytes(form="dense", n=256)


def test_lane_offsets_cover_csr_lanes():
    """The in-lane index's offsets are the graph's own CSC column
    pointers where every real lane is weighted: K9's index covers the CSR
    lanes, the padded ones left out."""
    src, dst, n = FAMILIES["random_ragged"]
    tg = _carry(JCSR.from_edges(src, dst, n))
    n_pad = tg.n_padded()
    lanes = np.full(tg.m_pad, np.inf, np.float32)
    lanes[: tg.n_edges] = 1.0
    w = lane_weights_from_array(lanes, n_edges=tg.n_edges, m_pad=tg.m_pad,
                                device="cpu")
    off = tkern.in_lanes(tg.src, tg.dst, w, n_pad).offsets
    assert off.dtype == torch.int32 and off.shape == (n_pad + 1,)
    np.testing.assert_array_equal(off[: n + 1].numpy(), tg.indptr_t.numpy())
    assert int(off[-1]) == tg.n_edges


# --------------------------------------------------------------------------
# the tropical forms
# --------------------------------------------------------------------------

def _weighted(family, seed=0):
    src, dst, n = FAMILIES[family]
    jg = JCSR.from_edges(src, dst, n)
    rng = np.random.default_rng(seed)
    lanes = np.full(jg.m_pad, np.inf, np.float32)
    lanes[: jg.n_edges] = rng.uniform(0.5, 4.0, jg.n_edges)
    return jg, lanes


@pytest.mark.parametrize("family", ["random_ragged", "duplicate_edges",
                                    "star_in", "clique"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_tropical_forms_dense_equals_sparse_and_jax(family, use_kernel):
    jg, lanes = _weighted(family, seed=len(family))
    tg = _carry(jg)
    n_pad = jg.n_padded()
    wdense = np.asarray(jnp.full((n_pad, n_pad), jnp.inf).at[
        jg.src, jg.dst].min(jnp.asarray(lanes)))
    rng = np.random.default_rng(jg.n_nodes)
    s = 16
    d = np.where(rng.random((s, n_pad)) < 0.4,
                 rng.uniform(0.0, 6.0, (s, n_pad)),
                 np.inf).astype(np.float32)
    f = ((rng.random((s, n_pad)) < 0.3) & np.isfinite(d)).astype(np.int8)
    d[:, jg.n_nodes:] = np.inf
    f[:, jg.n_nodes:] = 0
    kw = dict(n_pad=n_pad, use_kernel=use_kernel)
    jforms = jsweep.tropical_forms(jnp.asarray(wdense), jg.src, jg.dst,
                                   jnp.asarray(lanes), interpret=True, **kw)
    w_t = lane_weights_from_array(lanes, n_edges=jg.n_edges, m_pad=jg.m_pad,
                                  device="cpu")
    tforms = tsweep.tropical_forms(_t(wdense), tg.src, tg.dst, w_t, **kw)
    p = torch.zeros(1, dtype=torch.int32)
    outs = []
    for jf, tf in zip(jforms, tforms):
        want = jf(jnp.asarray(f), jnp.asarray(d), jnp.zeros(1, jnp.int32), 3)
        got = tf(_t(f), _t(d), p, 3)
        _same(want[:2], got[:2])
        outs.append(got)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_tropical_forms_sparse_only_and_unmasked():
    """wdense None gives no dense form; use_frontier=False relaxes every
    lane, on 1-D single-source state as well."""
    jg, lanes = _weighted("path")
    tg = _carry(jg)
    n = jg.n_nodes
    w_t = torch.from_numpy(lanes)
    dense, sparse = tsweep.tropical_forms(None, tg.src, tg.dst, w_t)
    assert dense is None
    jd, jsp = jsweep.tropical_forms(None, jg.src, jg.dst,
                                    jnp.asarray(lanes), use_frontier=False)
    _, tsp = tsweep.tropical_forms(None, tg.src, tg.dst, w_t,
                                   use_frontier=False)
    d = np.full(n + 1, np.inf, np.float32)
    d[:5] = np.arange(5, dtype=np.float32)
    f = np.zeros(n + 1, np.int8)
    p = torch.zeros(1, dtype=torch.int32)
    _same(jsp(jnp.asarray(f), jnp.asarray(d), jnp.zeros(1, jnp.int32), 1)[:2],
          tsp(_t(f), _t(d), p, 1)[:2])
    with pytest.raises(ValueError, match="frontier-gated"):
        tsweep.tropical_forms(None, tg.src, tg.dst, w_t, use_kernel=True,
                              use_frontier=False)


@pytest.mark.parametrize("kdim,chunk", [(128, 128), (256, 64), (384, 512)])
def test_minplus_candidates_matches_jax(kdim, chunk):
    rng = np.random.default_rng(kdim + chunk)
    s, n = 8, 256
    fd = np.where(rng.random((s, kdim)) < 0.3,
                  rng.uniform(0.0, 5.0, (s, kdim)),
                  np.inf).astype(np.float32)
    w = np.where(rng.random((kdim, n)) < 0.05,
                 rng.uniform(0.5, 4.0, (kdim, n)),
                 np.inf).astype(np.float32)
    want = jsweep.minplus_candidates(jnp.asarray(fd), jnp.asarray(w),
                                     chunk=chunk)
    got = tsweep.minplus_candidates(_t(fd), _t(w), chunk=chunk)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # the plain K7 product takes the k axis in chunks instead: same bits
    np.testing.assert_array_equal(
        got.numpy(), tkern.ref.minplus_product(_t(fd), _t(w)).numpy())


@pytest.mark.parametrize("family", ["random_ragged", "duplicate_edges",
                                    "two_components", "cycle"])
def test_weighted_derive_parents_matches_jax(family):
    """Parents from the converged weighted distances: the max-src
    in-neighbour u with dist[u] + w(u, v) == dist[v]."""
    from repro.core.weighted import WeightedConfig as JCfg
    from repro.core.weighted import weighted_apsp as japsp
    jg, lanes = _weighted(family, seed=3)
    tg = _carry(jg)
    sources = np.arange(min(jg.n_nodes, 8), dtype=np.int32)
    res = japsp(jg, lanes, sources, config=JCfg(mode="sparse",
                                                source_batch=8))
    dist = np.asarray(res.dist)
    want = jsweep.derive_parents(jg, jnp.asarray(dist),
                                 weights=jnp.asarray(lanes))
    got = tsweep.derive_parents(tg, _t(dist), weights=lanes)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got.numpy()[np.isfinite(dist) & (dist > 0)] >= 0).all()


@pytest.mark.parametrize("n_run", [0, 6, 40])
def test_fused_minplus_multisweep_with_index_matches_pallas(n_run):
    """K8 handed the live-word index (built by its plain builder) on the
    state above: the same new / dist / prod / stopped as without it and
    as the Pallas kernel.  On the CPU the plain version reads no index."""
    f, w, dist = _fused_start()
    kw = dict(bs=64, max_sweeps=max(n_run, 1))
    want = jkern.fused_minplus_multisweep(
        jnp.asarray(f), jnp.asarray(w), jnp.asarray(dist), 0, n_run,
        interpret=True, **kw)
    plain = tkern.fused_minplus_multisweep(_t(f), _t(w), _t(dist), 0, n_run,
                                           **kw)
    got = tkern.fused_minplus_multisweep(
        _t(f), _t(w), _t(dist), 0, n_run,
        index=tkern.finite_words_ref(_t(w)), **kw)
    _same(want[:2], got[:2])
    _same(tuple(x.numpy() for x in plain[:2]), got[:2])
    assert int(want[2]) == int(got[2]) == int(plain[2])
    assert bool(want[3]) == bool(got[3]) == bool(plain[3])


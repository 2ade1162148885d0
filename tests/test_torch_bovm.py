"""The port's boolean kernel wrappers (K1-K4) on CPU tensors — their plain
versions, with the wrappers' tables, tiles and fused accounting — against
the JAX Pallas kernels in interpret mode, bit for bit."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import pack_bits as jpack
from repro.graph import generators as jgen
from repro.kernels.bovm import (fused_boolean_multisweep as j_fused_multi,
                                fused_sweep as j_fused_sweep,
                                pack_adjacency_pull,
                                packed_pull_sweep as j_pull,
                                packed_push_sweep as j_push)
from repro_torch.core import pack_bits as tpack
from repro_torch.core import resolve_fused_steps
from repro_torch.graph import generators as tgen
from repro_torch.graph.csr import CSRGraph
from repro_torch.kernels import common, registry
from repro_torch.kernels import bovm


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _state(rng, s, n, density=0.05, visited=0.2):
    f = (rng.random((s, n)) < density).astype(np.int8)
    dist = np.where(rng.random((s, n)) < visited, 1, -1).astype(np.int32)
    return f, dist


def _adj(n, p, seed):
    return (np.random.default_rng(seed).random((n, n)) < p).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _words(a_u32) -> torch.Tensor:
    return _t(np.asarray(a_u32).view(np.int32))


def _eq(jax_out, torch_out):
    for j, t in zip(jax_out, torch_out):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

def test_registry_boolean_set():
    ks = registry.get("boolean")
    assert registry.available() == ("boolean", "counting", "tropical")
    assert set(ks.forms) == {"push", "push_f32", "pull"}
    assert ks.forms["push"] is bovm.packed_push_sweep
    assert ks.forms["pull"] is bovm.packed_pull_sweep
    assert ks.forms["push_f32"] is bovm.fused_sweep
    assert ks.fused_forms == {"push": bovm.fused_boolean_multisweep}
    assert ks.dispatchable("push", interpret=False)
    with pytest.raises(KeyError, match="min_label"):
        registry.get("min_label")


def test_smem_budget_and_fused_gate():
    """Only the fused form is priced, at one CTA of its cluster; the gate
    admits the full-width smoke graph (n_pad 65,664) and n_pad up to
    264,704, and trips above it."""
    ks = registry.get("boolean")
    for form in ("push", "pull", "push_f32"):
        with pytest.raises(ValueError, match="only the fused form"):
            ks.smem_bytes(form=form)
    assert ks.smem_bytes(form="fused", n=65_664) == \
        bovm.fused_smem_bytes(65_664, bovm.kernel.FUSED_ROWS,
                              bovm.kernel.FUSED_CLUSTER)
    assert ks.smem_bytes(form="fused", n=65_664) <= common.SMEM_BUDGET_BYTES
    assert ks.smem_bytes(form="fused", n=264_704) <= \
        common.SMEM_BUDGET_BYTES
    assert ks.smem_bytes(form="fused", n=264_832) > \
        common.SMEM_BUDGET_BYTES
    kw = dict(max_steps=64, use_kernel=True, bs=128)
    assert resolve_fused_steps("boolean", "push", fused_steps=-1,
                               n_pad=65_664, **kw) == 64
    assert resolve_fused_steps("boolean", "push", fused_steps=4,
                               n_pad=65_664, **kw) == 4
    assert resolve_fused_steps("boolean", "push", fused_steps=-1,
                               n_pad=264_704, **kw) == 64
    assert resolve_fused_steps("boolean", "push", fused_steps=-1,
                               n_pad=264_832, **kw) is None
    assert resolve_fused_steps("boolean", "pull", fused_steps=-1,
                               n_pad=1152, **kw) is None
    assert resolve_fused_steps("boolean", "push", fused_steps=-1,
                               n_pad=1152, max_steps=64, use_kernel=False,
                               bs=128) is None
    assert resolve_fused_steps("tropical", "dense", fused_steps=-1,
                               n_pad=1152, **kw) == 64


# (s, n, bs, n_run, max_sweeps, accepted): the shapes the K3 wrapper took
# and refused before its kernel moved to 32-row cluster tiles
K3_SHAPES = [
    (16, 256, 16, 2, 2, True), (8, 128, 8, 1, 1, True),
    (40, 128, 8, 3, 3, True), (24, 384, 24, 0, 1, True),
    (12, 128, 4, 1, 1, False),            # S not a multiple of 8
    (16, 192, 16, 1, 1, False),           # n not a multiple of 128
    (16, 256, 32, 1, 1, False),           # bs does not divide S
    (16, 256, 16, 3, 2, False),           # n_run above max_sweeps
]

# (s, n, k, bs, bn, bk, accepted) for K4 on the CPU (bs % 8 is a card check)
K4_SHAPES = [
    (8, 256, 256, 8, 128, 128, True), (12, 256, 256, 4, 128, 128, True),
    (40, 448, 448, 8, 64, 32, True), (16, 256, 512, 16, 128, 256, True),
    (16, 256, 256, 16, 96, 128, False),   # bn does not divide n
    (16, 256, 256, 16, 128, 96, False),   # bk does not divide k
    (16, 256, 256, 32, 128, 128, False),  # bs does not divide S
]


@pytest.mark.parametrize("s,n,bs,n_run,max_sweeps,accepted", K3_SHAPES)
def test_fused_multisweep_accepts_same_shapes(s, n, bs, n_run, max_sweeps,
                                              accepted):
    rng = np.random.default_rng(s + n)
    f, dist = _state(rng, s, n)
    at = _t((rng.random((n, n // 32)) < 0.1).astype(np.int32))
    call = lambda: bovm.fused_boolean_multisweep(  # noqa: E731
        _t(f), at, _t(dist), 0, n_run, bs=bs, max_sweeps=max_sweeps)
    if accepted:
        new, d, prod, stopped = call()
        assert new.shape == (s, n) and d.dtype == torch.int32
    else:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("s,n,k,bs,bn,bk,accepted", K4_SHAPES)
def test_fused_sweep_accepts_same_shapes(s, n, k, bs, bn, bk, accepted):
    rng = np.random.default_rng(s + n + k)
    f = _t((rng.random((s, k)) < 0.05).astype(np.int8))
    adj = _t((rng.random((k, n)) < 0.05).astype(np.int8))
    dist = _t(np.where(rng.random((s, n)) < 0.2, 1, -1).astype(np.int32))
    call = lambda: bovm.fused_sweep(f, adj, dist, 2, bs=bs, bn=bn,  # noqa
                                    bk=bk)
    if accepted:
        new, d = call()
        assert new.shape == (s, n) and d.shape == (s, n)
    else:
        with pytest.raises(ValueError):
            call()


def test_block_any_matches_reshape_reduction():
    rng = np.random.default_rng(0)
    m = rng.random((16, 24)) < 0.05
    got = common.block_any(_t(m), 4, 4, 3, 8).numpy()
    np.testing.assert_array_equal(got, m.reshape(4, 4, 3, 8).any((1, 3)))


# --------------------------------------------------------------------------
# K1 / K2: bit-packed sweeps
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,n,bs,bn,wk", [
    (128, 256, 128, 128, 8),
    (64, 512, 64, 128, 16),
    (8, 128, 8, 128, 4),
    (256, 384, 128, 128, 4),
])
def test_packed_push_matches_jax(s, n, bs, bn, wk):
    rng = np.random.default_rng(3 * s + n)
    g = jgen.erdos_renyi(n, 5.0, seed=n + 2, directed=True)
    adj = np.asarray(g.to_dense_padded(n))
    ap = pack_adjacency_pull(jnp.asarray(adj))
    f, dist = _state(rng, s, n)
    fp = jpack(jnp.asarray(f) > 0)
    want = j_push(fp, ap, jnp.asarray(dist), 3, bs=bs, bn=bn, wk=wk,
                  interpret=True)
    got = bovm.packed_push_sweep(_words(fp), _words(ap), _t(dist), 3,
                                 bs=bs, bn=bn, wk=wk)
    _eq(want, got)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.int32


@pytest.mark.parametrize("s,n,bs,bn,wk", [
    (8, 256, 8, 128, 8),
    (16, 512, 8, 128, 16),
    (32, 128, 16, 128, 4),
])
def test_packed_pull_matches_jax(s, n, bs, bn, wk):
    rng = np.random.default_rng(s + n)
    g = jgen.erdos_renyi(n, 5.0, seed=n + 1, directed=True)
    adj = np.asarray(g.to_dense_padded(n))
    ap = pack_adjacency_pull(jnp.asarray(adj))
    f, dist = _state(rng, s, n)
    fp = jpack(jnp.asarray(f) > 0)
    want = j_pull(fp, ap, jnp.asarray(dist), 3, bs=bs, bn=bn, wk=wk,
                  interpret=True)
    got = bovm.packed_pull_sweep(_words(fp), _words(ap), _t(dist), 3,
                                 bs=bs, bn=bn, wk=wk)
    _eq(want, got)


def test_packed_push_tile_skip_matches_jax():
    """Adversarial occupancy: one frontier word block and one unreached
    block live; the gated plain version must equal the Pallas kernel."""
    n, s = 512, 128
    adj = _adj(n, 0.02, 5)
    f = np.zeros((s, n), np.int8)
    f[:, :32] = 1
    dist = np.zeros((s, n), np.int32)
    dist[:, 256:] = -1
    fp = jpack(jnp.asarray(f) > 0)
    ap = pack_adjacency_pull(jnp.asarray(adj))
    want = j_push(fp, ap, jnp.asarray(dist), 4, bs=128, bn=128, wk=4,
                  interpret=True)
    got = bovm.packed_push_sweep(_words(fp), _words(ap), _t(dist), 4,
                                 bs=128, bn=128, wk=4)
    _eq(want, got)
    assert got[0].sum() > 0


def test_packed_push_matches_int8_push():
    """K1 == K4 (the push_f32 control), bit for bit."""
    rng = np.random.default_rng(11)
    n, s = 256, 64
    adj = _adj(n, 0.03, 12)
    f, dist = _state(rng, s, n)
    p = bovm.packed_push_sweep(tpack(_t(f) != 0),
                               tpack(_t(adj).t() != 0), _t(dist), 5,
                               bs=64, bn=128, wk=8)
    g = bovm.fused_sweep(_t(f), _t(adj), _t(dist), 5, bs=64, bn=128,
                         bk=128)
    for a, b in zip(p, g):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_check_tiles_and_count_no_cpu_launch():
    bovm.reset_launches()
    f = torch.zeros((8, 4), dtype=torch.int32)
    at = torch.zeros((128, 4), dtype=torch.int32)
    d = torch.full((8, 128), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="tiles"):
        bovm.packed_push_sweep(f, at, d, 1, bs=16, bn=128, wk=4)
    with pytest.raises(ValueError, match="shapes"):
        bovm.packed_pull_sweep(f, at[:64], d, 1, bs=8, bn=64, wk=4)
    bovm.packed_pull_sweep(f, at, d, 1, bs=8, bn=128, wk=4)
    assert bovm.packed_pull_sweep.launches == 0       # plain version


# --------------------------------------------------------------------------
# the live-word index of the packed operand (read by K1 / K2 on the card)
# --------------------------------------------------------------------------

def _index_graph(kind):
    if kind == "rmat":
        return tgen.rmat(8, 6, directed=True, seed=5, device="cpu")
    if kind == "grid":
        return tgen.grid2d(12, 12, device="cpu")
    if kind == "hub":                      # column 0 hears from 299 nodes
        src = np.arange(1, 300)
        return CSRGraph.from_edges(src, np.zeros_like(src), 300,
                                   device="cpu")
    if kind == "isolated_padded":          # 200 nodes padded to 256
        return CSRGraph.from_edges(np.array([0, 7, 150, 31, 32]),
                                   np.array([5, 100, 199, 33, 33]), 200,
                                   device="cpu")
    return CSRGraph.from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                               300, device="cpu")


@pytest.mark.parametrize("kind", ["rmat", "grid", "hub", "isolated_padded",
                                  "empty"])
def test_packed_index_matches_numpy(kind):
    """The plain builder of the packed operand's index against a numpy
    build: per column, the positions and values of its non-zero words."""
    g = _index_graph(kind)
    n = g.n_padded()
    adj = g.to_dense_padded(n).numpy() != 0
    at = np.ascontiguousarray(np.packbits(adj.T, axis=1,
                                          bitorder="little")).view("<u4")
    np.testing.assert_array_equal(g.to_pull_packed(n).numpy().view("<u4"),
                                  at)
    rows, cols = np.nonzero(at)
    idx = bovm.packed_live_words(g.to_pull_packed(n))
    counts = np.bincount(rows, minlength=n)
    np.testing.assert_array_equal(idx.offsets.numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    np.testing.assert_array_equal(idx.words.numpy(), cols)
    np.testing.assert_array_equal(idx.values.numpy().view("<u4"),
                                  at[rows, cols])
    assert idx.rows_live == int((counts > 0).sum())
    assert idx.offsets.dtype == idx.words.dtype == idx.values.dtype == \
        torch.int32
    assert bovm.packed_live_words.launches == 0       # plain version


def test_registry_boolean_operand_index():
    assert registry.get("boolean").operand_index is bovm.packed_live_words


@pytest.mark.parametrize("s,n,bs,bn,wk", [
    (128, 256, 128, 128, 8),
    (64, 512, 64, 128, 16),
    (8, 128, 8, 128, 4),
    (256, 384, 128, 128, 4),
])
def test_packed_push_with_index_matches_jax(s, n, bs, bn, wk):
    """K1 handed its operand's live-word index (which the plain version
    does not read) still equals the Pallas kernel."""
    rng = np.random.default_rng(3 * s + n)
    g = jgen.erdos_renyi(n, 5.0, seed=n + 2, directed=True)
    ap = pack_adjacency_pull(jnp.asarray(np.asarray(g.to_dense_padded(n))))
    f, dist = _state(rng, s, n)
    fp = jpack(jnp.asarray(f) > 0)
    want = j_push(fp, ap, jnp.asarray(dist), 3, bs=bs, bn=bn, wk=wk,
                  interpret=True)
    index = bovm.packed_live_words(_words(ap))
    got = bovm.packed_push_sweep(_words(fp), _words(ap), _t(dist), 3,
                                 bs=bs, bn=bn, wk=wk, index=index)
    _eq(want, got)


@pytest.mark.parametrize("s,n,bs,bn,wk", [
    (8, 256, 8, 128, 8),
    (16, 512, 8, 128, 16),
    (32, 128, 16, 128, 4),
])
def test_packed_pull_with_index_matches_jax(s, n, bs, bn, wk):
    rng = np.random.default_rng(s + n)
    g = jgen.erdos_renyi(n, 5.0, seed=n + 1, directed=True)
    ap = pack_adjacency_pull(jnp.asarray(np.asarray(g.to_dense_padded(n))))
    f, dist = _state(rng, s, n)
    fp = jpack(jnp.asarray(f) > 0)
    want = j_pull(fp, ap, jnp.asarray(dist), 3, bs=bs, bn=bn, wk=wk,
                  interpret=True)
    index = bovm.packed_live_words(_words(ap))
    got = bovm.packed_pull_sweep(_words(fp), _words(ap), _t(dist), 3,
                                 bs=bs, bn=bn, wk=wk, index=index)
    _eq(want, got)


def _malformed(index, kind):
    if kind == "other_operand":
        return bovm.packed_live_words(torch.zeros((256, 8),
                                                  dtype=torch.int32))
    if kind == "no_values":
        return index._replace(values=None)
    if kind == "short_values":
        return index._replace(values=index.values[:-1])
    if kind == "int64_words":
        return index._replace(words=index.words.long())
    return index._replace(offsets=index.offsets[None])


@pytest.mark.parametrize("kind", ["other_operand", "no_values",
                                  "short_values", "int64_words",
                                  "2d_offsets"])
@pytest.mark.parametrize("wrapper", ["push", "pull"])
def test_packed_wrappers_reject_malformed_index(kind, wrapper):
    g = tgen.erdos_renyi(120, 4.0, seed=1, device="cpu")
    at = g.to_pull_packed(128)
    fp = torch.zeros((8, 4), dtype=torch.int32)
    d = torch.full((8, 128), -1, dtype=torch.int32)
    kern = bovm.packed_push_sweep if wrapper == "push" else \
        bovm.packed_pull_sweep
    bad = _malformed(bovm.packed_live_words(at), kind)
    with pytest.raises(ValueError, match="index"):
        kern(fp, at, d, 1, bs=8, bn=128, wk=4, index=bad)
    # the well-formed index is taken
    kern(fp, at, d, 1, bs=8, bn=128, wk=4,
         index=bovm.packed_live_words(at))


# --------------------------------------------------------------------------
# K4: masked int8 GEMM push
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s,n,bs,bn,bk", [
    (64, 256, 64, 128, 128),
    (128, 512, 128, 128, 256),
    (8, 128, 8, 128, 128),
])
def test_fused_sweep_matches_jax(s, n, bs, bn, bk):
    rng = np.random.default_rng(s * n)
    g = jgen.erdos_renyi(n, 4.0, seed=n, directed=False)
    adj = np.asarray(g.to_dense_padded(n), np.int8)
    f, dist = _state(rng, s, n)
    want = j_fused_sweep(jnp.asarray(f), jnp.asarray(adj), jnp.asarray(dist),
                         5, bs=bs, bn=bn, bk=bk, interpret=True)
    got = bovm.fused_sweep(_t(f), _t(adj), _t(dist), 5, bs=bs, bn=bn, bk=bk)
    _eq(want, got)


# --------------------------------------------------------------------------
# K3: fused multi-sweep
# --------------------------------------------------------------------------

def _fused_pair(f, adj, dist, step, n_run, bs, max_sweeps):
    ap = pack_adjacency_pull(jnp.asarray(adj))
    want = j_fused_multi(jnp.asarray(f), ap, jnp.asarray(dist), step, n_run,
                         bs=bs, max_sweeps=max_sweeps, interpret=True)
    got = bovm.fused_boolean_multisweep(_t(f), _words(ap), _t(dist), step,
                                        n_run, bs=bs, max_sweeps=max_sweeps)
    _eq(want, got)
    return got


@pytest.mark.parametrize("n_run", [0, 1, 3, 7])
def test_fused_multisweep_matches_jax(n_run):
    rng = np.random.default_rng(n_run)
    n, s = 256, 128
    adj = _adj(n, 0.02, 40 + n_run)
    f = (rng.random((s, n)) < 0.02).astype(np.int8)
    dist = np.where(f != 0, 3, -1).astype(np.int32)
    new, _, prod, stopped = _fused_pair(f, adj, dist, 3, n_run, 128,
                                        max(n_run, 1))
    if n_run == 0:
        assert int(prod) == 0 and not bool(stopped) and new.sum() == 0


def test_fused_multisweep_converges_mid_block():
    n, s = 128, 8
    adj = np.zeros((n, n), np.int8)
    adj[[0, 1, 2], [1, 2, 3]] = 1
    f = np.zeros((s, n), np.int8)
    f[:, 0] = 1
    dist = np.full((s, n), -1, np.int32)
    dist[:, 0] = 0
    new, dist_out, prod, stopped = _fused_pair(f, adj, dist, 0, 8, 8, 8)
    assert int(prod) == 3 and bool(stopped) and new.sum() == 0
    assert dist_out[0, :5].tolist() == [0, 1, 2, 3, -1]


def test_fused_multisweep_not_converged_keeps_frontier():
    n, s = 128, 16
    adj = np.zeros((n, n), np.int8)
    adj[np.arange(20), np.arange(1, 21)] = 1
    f = np.zeros((s, n), np.int8)
    f[:, 0] = 1
    dist = np.full((s, n), -1, np.int32)
    dist[:, 0] = 0
    new, dist_out, prod, stopped = _fused_pair(f, adj, dist, 0, 5, 8, 5)
    assert int(prod) == 5 and not bool(stopped)
    assert new[0, 5] == 1 and new[0].sum() == 1 and dist_out[0, 5] == 5


def test_fused_multisweep_rejects_bad_shapes():
    at = torch.zeros((128, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_run"):
        bovm.fused_boolean_multisweep(
            torch.zeros((8, 128), dtype=torch.int8), at,
            torch.zeros((8, 128), dtype=torch.int32), 0, 3, bs=8,
            max_sweeps=2)
    with pytest.raises(ValueError, match="tiles"):
        bovm.fused_boolean_multisweep(
            torch.zeros((4, 128), dtype=torch.int8), at,
            torch.zeros((4, 128), dtype=torch.int32), 0, 1, bs=4,
            max_sweeps=2)


# --------------------------------------------------------------------------
# the frontier packer (pack_frontier): pack_bits on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["random", "all_ones", "column_slice"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 4097])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bool, torch.int32])
def test_pack_frontier_equals_pack_bits(dtype, n, layout):
    """The words of ``pack_frontier`` on the CPU are ``pack_bits``' and
    the JAX package's, bit for bit: any non-zero entry a set bit, tail
    bits zero, bit 31 the sign of the int32 (all-ones rows), and a column
    slice of a wider state (row stride above n) read through its
    stride."""
    rng = np.random.default_rng(n)
    rows = 3
    width = n + 40 if layout == "column_slice" else n
    x = rng.integers(-3, 4, (rows, width)) * (rng.random((rows, width)) < 0.3)
    if layout == "all_ones":
        x[:] = 1
    t = torch.from_numpy(x).to(dtype)
    if layout == "column_slice":
        t = t[:, 17: 17 + n]
        assert t.stride(0) == width > n
    got = bovm.pack_frontier(t)
    assert got.dtype == torch.int32 and got.shape == (rows, -(-n // 32))
    assert torch.equal(got, tpack(t))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpack(jnp.asarray(t.numpy() != 0))).view(
            np.int32))
    if layout == "all_ones":
        assert (got[:, : n // 32] == -1).all()
        if n % 32:
            assert int(got[0, -1]) == (1 << (n % 32)) - 1


def test_the_boolean_set_registers_the_packer():
    assert registry.get("boolean").pack is bovm.pack_frontier


@pytest.mark.parametrize("form", ["push", "pull"])
def test_kernel_forms_pack_through_pack_frontier(form):
    """The kernel branch of ``boolean_forms`` hands the frontier itself
    (no ``f != 0`` copy) to the boolean set's ``pack``
    (``pack_frontier``), once a sweep, and computes what the reference
    form does."""
    import dataclasses

    from repro_torch.core import sweep as S
    g = tgen.erdos_renyi(200, 4.0, seed=5, device="cpu")
    n_pad, s = g.n_padded(), 16
    at = g.to_pull_packed(n_pad)
    adj = g.to_dense_padded(n_pad)
    rng = np.random.default_rng(5)
    f = torch.from_numpy((rng.random((s, n_pad)) < 0.05).astype(np.int8))
    d = torch.from_numpy(np.where(f.numpy() != 0, 0, -1).astype(np.int32))
    dummy = torch.zeros(1, dtype=torch.int32)
    seen = []
    ks = registry.get("boolean")

    def counted(x):
        seen.append(x)
        return ks.pack(x)

    registry.register(dataclasses.replace(ks, pack=counted))
    try:
        k_forms = S.boolean_forms(None, at, dummy, dummy, n_pad=n_pad, s=s,
                                  use_kernel=True)
    finally:
        registry.register(ks)
    r_forms = S.boolean_forms(adj, at, dummy, dummy, n_pad=n_pad, s=s)
    i = {"push": S.PUSH, "pull": S.PULL}[form]
    got = k_forms[i](f, d, None, 1)
    assert len(seen) == 1 and seen[0] is f
    want = r_forms[i](f, d, None, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

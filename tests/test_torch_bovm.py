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
    assert registry.available() == ("boolean",)
    assert set(ks.forms) == {"push", "push_f32", "pull"}
    assert ks.forms["push"] is bovm.packed_push_sweep
    assert ks.forms["pull"] is bovm.packed_pull_sweep
    assert ks.forms["push_f32"] is bovm.fused_sweep
    assert ks.fused_forms == {"push": bovm.fused_boolean_multisweep}
    assert ks.dispatchable("push", interpret=False)
    with pytest.raises(KeyError, match="tropical"):
        registry.get("tropical")


def test_smem_budget_and_fused_gate():
    """Only the fused form is priced; its gate admits the full-width
    smoke graph (n_pad 65,664) and trips above the kernel's on-chip state
    limit."""
    ks = registry.get("boolean")
    for form in ("push", "pull", "push_f32"):
        with pytest.raises(ValueError, match="only the fused form"):
            ks.smem_bytes(form=form)
    assert ks.smem_bytes(form="fused", n=65_664) == \
        bovm.fused_smem_bytes(65_664, bovm.kernel.FUSED_ROWS)
    assert ks.smem_bytes(form="fused", n=65_664) <= common.SMEM_BUDGET_BYTES
    assert ks.smem_bytes(form="fused", n=4 * 65_664) > \
        common.SMEM_BUDGET_BYTES
    kw = dict(max_steps=64, use_kernel=True, bs=128)
    assert resolve_fused_steps("boolean", "push", fused_steps=-1,
                               n_pad=65_664, **kw) == 64
    assert resolve_fused_steps("boolean", "push", fused_steps=4,
                               n_pad=65_664, **kw) == 4
    assert resolve_fused_steps("boolean", "push", fused_steps=-1,
                               n_pad=80_000, **kw) is None
    assert resolve_fused_steps("boolean", "pull", fused_steps=-1,
                               n_pad=1152, **kw) is None
    assert resolve_fused_steps("boolean", "push", fused_steps=-1,
                               n_pad=1152, max_steps=64, use_kernel=False,
                               bs=128) is None
    assert resolve_fused_steps("tropical", "dense", fused_steps=-1,
                               n_pad=1152, **kw) is None


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

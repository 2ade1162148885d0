"""The port's CUDA kernels on the card against their plain versions, and the
engine's kernel path on the card against the CPU.  Needs an NVIDIA GPU
and nvcc; without CUDA every test here skips.

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import pack_bits
from repro_torch.core.engine import EngineConfig, apsp_engine, prepare_graph
from repro_torch.graph import generators as gen
from repro_torch.kernels import bovm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernels run only on the card")
    return torch.device("cuda")


def _state(seed, s, n, density=0.05, visited=0.2):
    rng = np.random.default_rng(seed)
    f = torch.from_numpy((rng.random((s, n)) < density).astype(np.int8))
    d = torch.from_numpy(np.where(rng.random((s, n)) < visited, 1, -1)
                         .astype(np.int32))
    return f, d


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("s,n,bs,wk", [(128, 512, 128, 4), (64, 384, 64, 4),
                                       (8, 256, 8, 8), (40, 1152, 40, 4)])
def test_packed_kernels_match_plain(cuda, s, n, bs, wk):
    g = gen.erdos_renyi(n - 1, 6.0, seed=n, device="cpu")
    at = g.to_pull_packed(n)
    f, d = _state(s + n, s, n)
    fp = pack_bits(f)
    before = bovm.packed_push_sweep.launches
    want = bovm.packed_push_sweep(fp, at, d, 4, bs=bs, bn=128, wk=wk)
    got = bovm.packed_push_sweep(fp.to(cuda), at.to(cuda), d.to(cuda), 4,
                                 bs=bs, bn=128, wk=wk)
    torch.cuda.synchronize()
    _same(want, got)
    assert bovm.packed_push_sweep.launches == before + 1
    got = bovm.packed_pull_sweep(fp.to(cuda), at.to(cuda), d.to(cuda), 4,
                                 bs=min(bs, 8), bn=128, wk=wk)
    _same(want, got)


@pytest.mark.parametrize("n_run", [0, 1, 3, 9])
def test_fused_kernel_matches_plain(cuda, n_run):
    g = gen.watts_strogatz(500, 6, 0.05, seed=n_run, device="cpu")
    n = g.n_padded()
    at = g.to_pull_packed(n)
    f = torch.zeros((16, n), dtype=torch.int8)
    f[torch.arange(16), torch.arange(16) * 31] = 1
    d = torch.where(f != 0, 0, -1).to(torch.int32)
    d[:, g.n_nodes:] = 0
    want = bovm.fused_boolean_multisweep(f, at, d, 0, n_run, bs=16,
                                         max_sweeps=max(n_run, 1))
    got = bovm.fused_boolean_multisweep(f.to(cuda), at.to(cuda), d.to(cuda),
                                        0, n_run, bs=16,
                                        max_sweeps=max(n_run, 1))
    _same(want, got)


@pytest.mark.parametrize("s,n,bs,bk", [(128, 512, 128, 128),
                                       (16, 256, 16, 256)])
def test_int8_kernel_matches_plain(cuda, s, n, bs, bk):
    adj = (torch.rand((n, n), generator=torch.Generator().manual_seed(n))
           < 0.02).to(torch.int8)
    f, d = _state(n, s, n)
    want = bovm.fused_sweep(f, adj, d, 6, bs=bs, bn=128, bk=bk)
    got = bovm.fused_sweep(f.to(cuda), adj.to(cuda), d.to(cuda), 6, bs=bs,
                           bn=128, bk=bk)
    _same(want, got)


@pytest.mark.parametrize("opts", [dict(), dict(mode="push"),
                                  dict(mode="pull"), dict(fused_steps=-1),
                                  dict(fused_steps=4)])
def test_engine_on_card_matches_cpu(cuda, opts):
    g = gen.rmat(10, 8, directed=False, seed=2, device="cpu")
    sources = np.arange(0, 1024, 5)
    cfg = EngineConfig(use_kernel=True, **opts)
    want = apsp_engine(prepare_graph(g, device="cpu"), sources, config=cfg)
    got = apsp_engine(prepare_graph(g, device=cuda), sources, config=cfg)
    assert torch.equal(want.dist, got.dist.cpu())
    assert want.sweeps == got.sweeps
    assert torch.equal(want.direction_counts, got.direction_counts)

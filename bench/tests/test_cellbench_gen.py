"""The generators: the same seed gives the same graph, and each recipe
has its published statistics."""
import math

import pytest
import torch

from bench import manifest
from bench.gen import kronecker, rgg


def _kron(scale=8):
    return dict(manifest.config(manifest.load(), "kron18"), scale=scale)


def _rgg(n=2048):
    return dict(manifest.config(manifest.load(), "rgg18"), n=n)


@pytest.mark.parametrize("mod,cfg", [(kronecker, _kron()), (rgg, _rgg())],
                         ids=["kronecker", "rgg"])
def test_same_seed_same_graph(mod, cfg):
    a = mod.generate(cfg, 2**31 + 17, torch.device("cpu"))
    b = mod.generate(cfg, 2**31 + 17, torch.device("cpu"))
    c = mod.generate(cfg, 2**31 + 18, torch.device("cpu"))
    assert a[2] == b[2] == c[2]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not (a[0].shape == c[0].shape and torch.equal(a[0], c[0])
                and torch.equal(a[1], c[1]))


def test_kronecker_tuple_count_and_ids():
    cfg = _kron(scale=9)
    src, dst, n = kronecker.generate(cfg, 5, torch.device("cpu"))
    assert n == 512
    assert src.numel() == dst.numel() == cfg["edgefactor"] * 512
    assert int(src.min()) >= 0 and int(torch.maximum(src, dst).max()) < n


def test_kronecker_initiator_per_bit():
    """Without the relabelling, each bit of a tuple falls in the
    initiator's quadrants A, B, C, D = 0.57, 0.19, 0.19, 0.05."""
    gen = torch.Generator().manual_seed(3)
    scale, ef = 10, 32
    src, dst = kronecker.tuples(scale, ef, 0.57, 0.19, 0.19, gen, "cpu",
                                permute=False)
    m = src.numel()
    for bit in range(scale):
        i, j = (src >> bit) & 1, (dst >> bit) & 1
        for (qi, qj), p in {(0, 0): 0.57, (0, 1): 0.19, (1, 0): 0.19,
                            (1, 1): 0.05}.items():
            share = float(((i == qi) & (j == qj)).sum()) / m
            assert abs(share - p) < 0.01, (bit, qi, qj, share)


def test_kronecker_permutes_labels():
    """The relabelled graph has the same degree multiset as the plain one
    (a permutation moves labels, not edges)."""
    def degrees(permute):
        gen = torch.Generator().manual_seed(9)
        s, d = kronecker.tuples(8, 8, 0.57, 0.19, 0.19, gen, "cpu",
                                permute=permute)
        return torch.sort(torch.bincount(torch.cat([s, d]),
                                         minlength=256)).values
    assert torch.equal(degrees(True), degrees(False))


def test_rgg_radius_of_the_published_graph():
    r = rgg.radius(1 << 18, 0.55)
    assert abs(r - 0.55 * math.sqrt(math.log(2**18) / 2**18)) < 1e-15
    assert 0.0037 < r < 0.0039


def test_rgg_pairs_equal_brute_force():
    gen = torch.Generator().manual_seed(4)
    pts = torch.rand((700, 2), generator=gen, dtype=torch.float64)
    r = rgg.radius(700, 0.55)
    src, dst = rgg.pairs(pts, r)
    d = pts[:, None, :] - pts[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    i, j = torch.nonzero(torch.triu(d2 < r * r, diagonal=1), as_tuple=True)
    assert torch.equal(src, i) and torch.equal(dst, j)


def test_rgg_mean_degree():
    """About pi r^2 (n - 1), less the disc's share outside the square."""
    n = 1 << 14
    src, dst, _ = rgg.generate(_rgg(n), 21, torch.device("cpu"))
    r = rgg.radius(n, 0.55)
    expect = math.pi * r * r * (n - 1) * (1 - 8 * r / (3 * math.pi))
    mean = 2 * src.numel() / n
    assert abs(mean - expect) / expect < 0.03, (mean, expect)

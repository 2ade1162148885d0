"""The reference search and components against a brute-force
breadth-first search, and the control against the reference."""
from collections import deque

import pytest
import torch

from bench import reference


def brute(n, edges, s):
    adj = [set() for _ in range(n)]
    for u, v in edges:
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    dist = [-1] * n
    dist[s] = 0
    q = deque([s])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if dist[v] < 0:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def random_graph(n, m, seed):
    """Tuples with duplicates and self-loops, several components."""
    gen = torch.Generator().manual_seed(seed)
    src = torch.randint(0, n, (m,), generator=gen)
    dst = torch.randint(0, n, (m,), generator=gen)
    return src, dst


@pytest.mark.parametrize("n,m,seed", [(30, 20, 0), (60, 90, 1), (100, 400, 2),
                                      (17, 17, 3)])
def test_bfs_rows_equal_brute_force(n, m, seed, monkeypatch):
    monkeypatch.setattr(reference, "PAIR_BUDGET", 64)    # several blocks
    src, dst = random_graph(n, m, seed)
    g = reference.Graph(src, dst, n)
    rows = reference.bfs_rows(g, list(range(n)))
    edges = list(zip(src.tolist(), dst.tolist()))
    for s in range(n):
        assert rows[s].tolist() == brute(n, edges, s)


@pytest.mark.parametrize("seed", [4, 5, 6])
def test_components_equal_reachable_sets(seed):
    n = 80
    src, dst = random_graph(n, 60, seed)
    g = reference.Graph(src, dst, n)
    edges = list(zip(src.tolist(), dst.tolist()))
    for s in range(n):
        reach = {v for v, d in enumerate(brute(n, edges, s)) if d >= 0}
        assert {v for v in range(n) if g.labels[v] == g.labels[s]} == reach
        assert int(g.labels[s]) == min(reach)


def test_graph_counts_drop_loops_and_duplicates():
    src = torch.tensor([0, 1, 1, 2, 3, 3])
    dst = torch.tensor([1, 0, 2, 2, 4, 4])
    g = reference.Graph(src, dst, 6)
    assert g.n_lanes == 6                       # 0-1, 1-2, 3-4 both ways
    assert g.degree.tolist() == [1, 2, 1, 1, 1, 0]
    assert int(g.comp_edges[g.labels[0]]) == 2
    assert int(g.comp_edges[g.labels[3]]) == 1
    assert int(g.comp_edges[g.labels[5]]) == 0


def test_control_drops_the_last_level():
    src, dst = torch.tensor([0, 1, 2, 4]), torch.tensor([1, 2, 3, 5])
    g = reference.Graph(src, dst, 7)
    full = reference.bfs_rows(g, [0, 4, 6])
    short = reference.bfs_rows(g, [0, 4, 6], levels_short=1)
    assert full.tolist()[0] == [0, 1, 2, 3, -1, -1, -1]
    assert short.tolist() == [[0, 1, 2, -1, -1, -1, -1],
                              [-1, -1, -1, -1, 0, -1, -1],
                              [-1, -1, -1, -1, -1, -1, 0]]

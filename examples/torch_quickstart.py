"""Quickstart: DAWN shortest paths through the port's ``dawn`` facade.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The PyTorch counterpart of ``examples/quickstart.py``: the same graph,
steps, printed lines and checks.
"""
import argparse

import numpy as np

import repro_torch as dawn
from repro_torch.core import bfs_scipy
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. build a graph (or CSRGraph.from_edges / repro_torch.graph.io)
    g = gen.watts_strogatz(5000, 8, 0.05, seed=0, device=dev)
    print(f"graph: {g.n_nodes} nodes, {g.n_edges} edges")

    # 2. wrap it in a handle — one verb for every semiring and topology
    h = dawn.prepare(g, device=dev)

    # 3. single-source shortest paths (auto-dispatches BOVM/SOVM)
    dist = h.sssp(0).cpu().numpy()
    print(f"SSSP from 0: eccentricity={int(dist.max())}, "
          f"reachable={int((dist >= 0).sum())}")

    # 4. verify against scipy's C BFS
    assert (dist == bfs_scipy(g, 0)).all()
    print("matches scipy.sparse.csgraph ✓")

    # 5. batched multi-source (one product over 64 frontier rows)
    batch = h.apsp(np.arange(64))
    print(f"64-source batch: dist matrix {tuple(batch.dist.shape)}, "
          f"{int(batch.sweeps)} sweeps, "
          f"edges touched={int(batch.edges_touched)}")

    # 6. the same call works on a mutable graph — mutate, query, repeat
    dg = dawn.DynamicCSRGraph(g)
    hd = dawn.prepare(dg, device=dev)
    base = hd.sssp(0).cpu().numpy()
    far = int(np.argmax(base))                     # most distant node
    hd.insert_edges([0], [far])                    # add a shortcut edge
    after = hd.sssp(0).cpu().numpy()               # fresh epoch, same call
    print(f"dynamic: dist[{far}] {int(base[far])} → {int(after[far])} "
          f"after inserting shortcut (epoch {hd.epoch})")


if __name__ == "__main__":
    main()

"""End-to-end graph analytics driver built on the port's batched
subsystems.

Computes, for any generated or on-disk graph:
  connectivity (WCC sizes) → one batched centrality run over the counting
  semiring (closeness / harmonic / exact eccentricity + radius/diameter /
  exact Brandes betweenness) → sample shortest paths → weighted APSP
  through the tropical semiring.  All query dispatch goes through the
  unified ``dawn`` facade: one ``prepare`` handle serves every semiring.

    PYTHONPATH=src python examples/torch_graph_analytics.py --graph rmat \
        --scale 10 --sources 128                       # the card
    PYTHONPATH=src python examples/torch_graph_analytics.py --device cpu

The PyTorch counterpart of ``examples/graph_analytics.py``: the same
graphs, seeds (the lane weights are numpy's draws, the JAX script's
bits) and printed lines.
"""
import argparse
import time

import numpy as np

import repro_torch as dawn
from repro_torch.core import reconstruct_path, sssp, wcc_stats
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import resolve_device
from repro_torch.graph.io import load_edgelist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat",
                    choices=["rmat", "grid", "ws", "disconnected", "file"])
    ap.add_argument("--path", help="edge list path for --graph file")
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--sources", type=int, default=128,
                    help="sources for the centrality run (restricting "
                         "them gives the standard source-sampled "
                         "betweenness estimator; pass 0 for all nodes "
                         "= exact)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.graph == "rmat":
        g = gen.rmat(args.scale, 8, directed=False, seed=1, device=dev)
    elif args.graph == "grid":
        side = int(2 ** (args.scale / 2))
        g = gen.grid2d(side, side, device=dev)
    elif args.graph == "ws":
        g = gen.watts_strogatz(2 ** args.scale, 8, 0.05, seed=1, device=dev)
    elif args.graph == "disconnected":
        g = gen.disconnected(2 ** (args.scale - 7), 128, 4.0, seed=1,
                             device=dev)
    else:
        g = load_edgelist(args.path, undirected=True, device=dev)
    print(f"graph: {g.n_nodes} nodes / {g.n_edges} edges")

    # one facade handle drives every semiring below; weights attach here
    rng = np.random.default_rng(0)
    w = rng.uniform(0.5, 4.0, g.m_pad).astype(np.float32)
    h = dawn.prepare(g, weights=w, source_batch=128, device=dev)

    t0 = time.perf_counter()
    stats = wcc_stats(g)
    print(f"WCC: {stats['n_components']} components, "
          f"S_wcc={stats['S_wcc']} E_wcc={stats['E_wcc']} "
          f"({time.perf_counter() - t0:.2f}s)")

    # ONE batched run over the counting semiring produces every measure:
    # the forward sweeps carry (dist, sigma), the Brandes backward pass
    # accumulates dependencies over the recorded levels, and the
    # distance reductions fall out of the same dist rows.
    n_src = g.n_nodes if args.sources in (0, None) else \
        min(args.sources, g.n_nodes)
    sources = np.arange(n_src, dtype=np.int32)
    t0 = time.perf_counter()
    res = h.centrality(sources)
    dt = time.perf_counter() - t0
    exact = "exact" if n_src == g.n_nodes else f"{n_src}-source estimate"
    print(f"centrality ({exact}) in {dt:.2f}s "
          f"({dt / n_src * 1e3:.1f} ms/source, {res.sweeps} sweeps)")
    print(f"  eccentricity: radius={res.radius} diameter={res.diameter} "
          f"mean={res.eccentricity.mean():.1f}")
    top = np.argsort(res.betweenness)[-5:][::-1]
    print("  top betweenness:",
          [(int(v), round(float(res.betweenness[v]), 1)) for v in top])
    top_c = np.argsort(res.closeness)[-3:][::-1]
    print("  top closeness:  ",
          [(int(sources[v]), round(float(res.closeness[v]), 4))
           for v in top_c])
    print(f"  harmonic: mean={res.harmonic.mean():.2f} "
          f"max={res.harmonic.max():.2f}")

    # sample path reconstruction — every SsspResult carries a parent tree
    res0 = sssp(g, int(top[0]))
    d0 = res0.dist.cpu().numpy()
    far = int(np.argmax(d0))
    path = reconstruct_path(res0.parent, int(top[0]), far, g.n_nodes)
    print(f"sample shortest path {int(top[0])} → {far} "
          f"(len {d0[far]}): {path[:12]}{'...' if len(path) > 12 else ''}")

    # weighted analytics ride the same sweep core through the tropical
    # semiring — same handle, different semiring=
    t0 = time.perf_counter()
    wres = h.apsp(sources[: min(32, len(sources))], semiring="tropical")
    wd = wres.dist.cpu().numpy()
    forms = dict(zip(("dense", "sparse"), wres.direction_counts.tolist()))
    print(f"weighted APSP ({wd.shape[0]} sources) in "
          f"{time.perf_counter() - t0:.2f}s — forms {forms}, "
          f"mean finite dist {wd[np.isfinite(wd)].mean():.2f}")


if __name__ == "__main__":
    main()

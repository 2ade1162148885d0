"""Direction-optimizing batched APSP, and graph queries in the serving
loop, through the port's ``dawn`` facade.

    PYTHONPATH=src python examples/torch_apsp_engine.py              # the card
    PYTHONPATH=src python examples/torch_apsp_engine.py --device cpu

The PyTorch counterpart of ``examples/apsp_engine.py``.  Part 1 runs
tiled all-pairs shortest paths over a road-network-like graph and prints
which sweep forms the engine chose.  Part 2 stands up the tiered,
continuously-batching GraphService — built from the same facade handle —
and serves point-to-point queries, a k-nearest lookup, and a centrality
analytic, then mutates the graph and shows the epoch guard invalidating
the serving-tier caches.
"""
import argparse

import numpy as np

import repro_torch as dawn
from repro_torch.graph import generators as gen
from repro_torch.graph.csr import resolve_device
from repro_torch.serve import GraphQuery


def part1_batched_apsp(dev):
    g = gen.grid2d(32, 32, device=dev)          # 1024-node road grid
    stats = g.degree_stats()
    print(f"graph: n={stats.n_nodes} m={stats.n_edges} "
          f"avg_deg={stats.avg_degree:.1f} density={stats.density:.2%}")

    h = dawn.prepare(g, source_batch=128, device=dev)  # dense + packed
    res = h.apsp()                               # all sources
    dirs = dict(zip(("push", "pull", "sparse"),
                    res.direction_counts.tolist()))
    print(f"APSP over all {stats.n_nodes} sources: dist "
          f"{tuple(res.dist.shape)}, {int(res.sweeps)} sweeps/tile max, "
          f"directions {dirs}")
    ecc = int(res.dist.max())
    print(f"graph diameter (max eccentricity): {ecc}")


def part2_serving(dev):
    dg = dawn.DynamicCSRGraph(gen.watts_strogatz(512, 8, 0.05, seed=1,
                                                 device=dev))
    svc = dawn.prepare(dg, device=dev).serve(max_batch=16, n_landmarks=8)

    for i in range(20):
        svc.submit(GraphQuery(qid=i, source=i * 7 % 512, target=200))
    svc.submit(GraphQuery(qid=20, source=3, k_nearest=5))
    svc.submit(GraphQuery(qid=21, source=200, analytics=("closeness",)))
    done = []
    while svc.pending():                 # each flush serves one batch
        done.extend(svc.flush())

    hops = [q.hops for q in done if q.target is not None]
    tiers = sorted({q.served_by for q in done})
    print(f"graph queries: {len(done)} served via {tiers}, "
          f"hops to node 200: {hops}")
    knn = next(q for q in done if q.k_nearest)
    print(f"5 nearest to node 3: {knn.nearest}")
    cen = next(q for q in done if q.analytics)
    print(f"closeness(200) = {cen.analytics_result['closeness']:.4f}")

    # mutate the live graph — the service notices the epoch change and
    # rebuilds operands / drops stale caches before the next answer
    def ask(qid):
        svc.submit(GraphQuery(qid=qid, source=3, target=200))
        svc.flush()
        q = [x for x in svc.drain_completed() if x.qid == qid][0]
        return q.hops, q.served_by

    svc.drain_completed()
    before, tier_b = ask(22)             # row-cache hit from the k-NN row
    dg.insert_edges([3], [200])
    after, tier_a = ask(23)              # epoch guard forces a fresh sweep
    print(f"insert (3, 200): hops {before} ({tier_b}) → {after} ({tier_a}), "
          f"{svc.epoch_invalidations} epoch invalidation")
    assert (before, tier_b) != (after, tier_a)
    assert svc.epoch_invalidations == 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    part1_batched_apsp(dev)
    part2_serving(dev)


if __name__ == "__main__":
    main()

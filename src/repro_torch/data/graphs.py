"""Graph batch builders for the GNN architectures (the port of
``repro/data/graphs.py``).

Produces the fixed-shape numpy batch dicts of the four shape regimes
(full_graph_sm / minibatch_lg / ogb_products / molecule), byte-identical
to the JAX package's for the same graph and seed, plus subgraph sampling
on top of :mod:`repro_torch.graph.sampler`.  A sampled batch draws its
neighbors from a ``torch.Generator`` on the graph's device (the JAX
package: a key), so its ids are its own; every field computed from the
sampled layers is the same function of them (``_batch_from_layers``)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..graph.csr import CSRGraph
from ..graph import generators as gen
from ..graph.sampler import sample_subgraph


def full_graph_batch(g: CSRGraph, *, d_feat: int, n_classes: int = 41,
                     seed: int = 0, with_geometry: bool = True
                     ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    n = g.n_nodes
    src, dst = g.edge_arrays_np()
    e_pad = g.m_pad
    src_p = np.full(e_pad, n, np.int32); src_p[:len(src)] = src
    dst_p = np.full(e_pad, n, np.int32); dst_p[:len(dst)] = dst
    batch = {
        "feat": rng.normal(size=(n, d_feat)).astype(np.float32),
        "src": src_p, "dst": dst_p,
        "labels": rng.integers(0, n_classes, n).astype(np.int32),
        "targets": rng.normal(size=(n, 2)).astype(np.float32),
        "node_mask": np.ones(n, bool),
    }
    if with_geometry:
        batch["pos"] = rng.normal(size=(n, 3)).astype(np.float32)
        batch["species"] = rng.integers(0, 50, n).astype(np.int32)
        batch["graph_id"] = np.zeros(n, np.int32)
        batch["energy"] = rng.normal(size=(1,)).astype(np.float32)
    return batch


def sampled_batch(g: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                  *, d_feat: int, n_classes: int = 41, seed: int = 0
                  ) -> Dict[str, np.ndarray]:
    """Fanout-sampled subgraph as a fixed-shape batch.  Node list =
    [seeds, hop1, hop2, ...]; edges connect hop h+1 → hop h (message flows
    toward the seeds).  Repeats allowed (standard GraphSAGE).  The
    neighbors come from a generator on the graph's device seeded with
    ``seed``."""
    generator = torch.Generator(device=g.device)
    generator.manual_seed(seed)
    layers = sample_subgraph(g, seeds, generator, fanouts)
    return _batch_from_layers([l.cpu().numpy() for l in layers], seeds,
                              fanouts, d_feat=d_feat, n_classes=n_classes,
                              seed=seed)


def _batch_from_layers(layers: Sequence[np.ndarray], seeds: np.ndarray,
                       fanouts: Sequence[int], *, d_feat: int,
                       n_classes: int, seed: int) -> Dict[str, np.ndarray]:
    """The batch of sampled host ``layers`` (layer 0 the seeds)."""
    offsets = np.cumsum([0] + [len(l) for l in layers])
    n_sub = int(offsets[-1])
    src_l, dst_l = [], []
    for h, f in enumerate(fanouts):
        parents = np.arange(offsets[h], offsets[h + 1])
        children = np.arange(offsets[h + 1], offsets[h + 2])
        src_l.append(children)                       # child → parent
        dst_l.append(np.repeat(parents, f))
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    all_nodes = np.concatenate(layers)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, int(seeds[0])]))
    feat = rng.normal(size=(n_sub, d_feat)).astype(np.float32)
    mask = np.zeros(n_sub, bool)
    mask[: len(seeds)] = True                         # loss on seeds only
    return {
        "feat": feat, "src": src, "dst": dst,
        "labels": (all_nodes % n_classes).astype(np.int32),
        "targets": rng.normal(size=(n_sub, 2)).astype(np.float32),
        "node_mask": mask,
        "pos": rng.normal(size=(n_sub, 3)).astype(np.float32),
        "species": (all_nodes % 50).astype(np.int32),
        "graph_id": np.zeros(n_sub, np.int32),
        "energy": rng.normal(size=(1,)).astype(np.float32),
    }


def molecule_batch(*, batch: int = 128, n_nodes: int = 30, n_edges: int = 64,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """``batch`` small molecules flattened into one disjoint graph."""
    rng = np.random.default_rng(seed)
    n_tot, e_tot = batch * n_nodes, batch * n_edges
    pos = rng.normal(size=(n_tot, 3)).astype(np.float32) * 2.0
    src = np.zeros(e_tot, np.int32)
    dst = np.zeros(e_tot, np.int32)
    for b in range(batch):
        s = rng.integers(0, n_nodes, n_edges)
        d = (s + 1 + rng.integers(0, n_nodes - 1, n_edges)) % n_nodes
        src[b * n_edges:(b + 1) * n_edges] = s + b * n_nodes
        dst[b * n_edges:(b + 1) * n_edges] = d + b * n_nodes
    return {
        "feat": rng.normal(size=(n_tot, 8)).astype(np.float32),
        "pos": pos, "src": src, "dst": dst,
        "species": rng.integers(0, 20, n_tot).astype(np.int32),
        "graph_id": np.repeat(np.arange(batch), n_nodes).astype(np.int32),
        "energy": rng.normal(size=(batch,)).astype(np.float32),
        "labels": rng.integers(0, 41, n_tot).astype(np.int32),
        "targets": rng.normal(size=(n_tot, 2)).astype(np.float32),
        "node_mask": np.ones(n_tot, bool),
    }


def demo_graph(kind: str = "small", seed: int = 0, *,
               device=None) -> CSRGraph:
    """A demo host graph on ``device`` (``None``: the card)."""
    if kind == "small":
        return gen.watts_strogatz(2708, 8, 0.05, seed=seed,   # Cora-sized
                                  device=device)
    if kind == "reddit":                     # sampled-training host graph
        return gen.rmat(13, 24, directed=False, seed=seed, device=device)
    raise ValueError(kind)

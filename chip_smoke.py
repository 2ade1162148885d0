#!/usr/bin/env python3
"""Run the PyTorch port of DAWN end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch`` (into
``build/repro_torch/``), holds the frontier packer (``pack_frontier``)
bit for bit to ``pack_bits`` and times both at the cells' shapes against
the packer's bytes bound on the empty card (phase ``pack``; the rows join
the kernel table), drives the boolean engine through
``repro_torch.prepare(graph).apsp(sources)`` on two graphs of 65,536
nodes made by the port's own generators, then the counting engine
(``apsp(sources, semiring="counting")``) and the centrality analytics
(``prepare(graph).centrality(sources)``) on rmat16, then the tropical
(weighted) engine (``prepare(graph, weights=w).apsp(sources,
semiring="tropical")``) on both graphs.  It checks distances against
scipy's BFS, path counts against a float64 count on the host,
betweenness against a float64 Brandes on the host, weighted distances
against scipy's Dijkstra and a float32 Bellman-Ford replay on the host,
and holds every kernel bit-identical to its plain PyTorch version at
full width: on rmat16 after 2 sweeps, and K1-K3 and K7-K9 also on
grid256's thin frontier after 200 sweeps, where most of their launches
run (K8 there 4 sweeps per launch: its plain version reads the whole
float32 operand every sweep); the
four index builders, the live-word indexes that K1 / K2, K5 / K6 and
K7 / K8 read (``packed_live_words`` on both graphs' packed operands,
``nonzero_words``, ``finite_words`` on the rmat16 operands) and K9's
in-lane index (``in_lanes`` on both graphs' lanes), are timed and held
to their plain versions (phase ``index``).  K1, K2 and K9 also carry
``device_ms``, one call replayed from a CUDA graph: the card's time
alone, where the host takes about as long to issue a call as the card
takes to run it.  Each kernel
line carries its state and its main-path launches per graph
(``tools/kernel_table.py`` ranks the kernels from them).  The packed
bound is printed beside the earlier rule's (phase ``bound_recount``).

Then the low-level boolean paths on rmat16: ``wcc`` against scipy's weak
components (phase ``wcc``), and the full-BFS drivers ``msbfs_kernel``
(K4 in every sweep) and ``msbfs_packed`` (K2 in every sweep, its index
built once) on 128 sources against scipy's BFS (phases
``msbfs_kernel``, ``msbfs_packed``).  Last, the dynamic path (phase
``dynamic``): each graph wrapped in a ``DynamicCSRGraph``, 6 rounds of
``bench_dynamic``'s update stream (a 32-node index window a round, 6
random pairs inserted both ways, the shortcuts of two rounds earlier
deleted; the recipe is copied here), a compaction after round 3, and
``prepare(dg).incremental(sources).update()`` each round held equal to a
fresh ``sssp_state`` of the mutated graph: unweighted on rmat16 (its
first 128 sources) and grid256, weighted on rmat16 (inserts weighted
like the lanes).  Each repair's resumed sweeps are K9 over the in-lane
index of the view it repairs, built once per view; each round also holds
one K9 sweep over that view and index against its plain version (the
scratch run may be K9 too).  Each line prints the repair and scratch
sweeps and host seconds, the K9 and ``in_lanes`` launches of the
repairs, the seconds in ``view()`` and the peak device memory; every
source's row of the final graph is held to scipy, directly and through
the facade.

Then the serving tier (phase ``serve``), through ``prepare(rmat16,
weights=w).serve(...)`` under a virtual clock with ``bench_serving``'s
workload recipe (copied here): stream A, 10,000 queries from a Zipf-hot
pool of 96 sources (60 % point-to-point, 20 % ``k_nearest=8``, 20 % full
rows) over 16 landmarks and a 96-row cache; stream B, 2,000 weighted
queries (K9 flushes); stream C, 1,000 queries on a pinned-push handle
with no oracle (every miss a K1 flush) and 64 analytics queries; the
epoch guard over a ``DynamicCSRGraph`` mutated by one round of the
dynamic phase's recipe; and a deadline run.  Every answer is held to
scipy (BFS, Dijkstra, float64 analytics); the certified count comes from
a replay on a bare ``DistanceOracle``.  Stream B must launch K9 and
stream C K1 on their own, and before the phase K1 and K9 are held bit
for bit against their plain versions at the flushes' 32 rows (phase
``serve_kernels``).  Last, resumable jobs (phase
``jobs``): ``prepare(rmat16, ...).apsp(512 sources, semiring=...,
checkpoint_dir=...)`` in chunks of 128 for the boolean (pinned push,
K1), counting (pinned push, K5) and tropical (default, K9) workloads, a
full run, a run killed after its second chunk and its resumed run, all
bit-identical to one ``apsp`` call, 16 rows held to the host; and one
CUDA leaf saved with ``blocking=False`` and overwritten at once.  Each
job run must launch its workload's kernel; the plain call is a
comparison and its launches are taken back out.  Last, the roofline
autotuner (phase ``tune``): on each graph ``prepare(g,
weights=w).tune(save=path)`` twice (the same checksum, op-count costs for
every semiring, each finite and positive; the fingerprint, unit costs,
tiles, fused gate, build seconds and peak memory printed), the saved plan
loaded back equal and a copy for another device refused, then the tuned
default runs through ``prepare(g, tuning=path, weights=w)``, twice each:
boolean and tropical on both graphs, counting and ``centrality`` on 128
sources on rmat16; each bit-identical to the untuned default run above
(centrality's float measures to the centrality phase's rtol), with equal
``direction_counts``, printed beside the untuned default and fused
seconds.  The tuned runs fuse: the phase must launch K3, K6 and K8.
Last, the sharded executor (phase ``sharded``) at world size 1: NCCL
started inside the script, a (1, 1) ``(data, model)`` mesh from
``make_mesh``; ``sharded_apsp`` on rmat16's 1,024 sources boolean dense
(K1), dense fused (K3), sparse and auto, counting dense (K5), tropical
dense (K7) and sparse (K9), and on grid256's 128 sources boolean dense
and tropical sparse, each held bit for bit to a single-device call of
the same pinned form (whose launches are taken back out) and to the
untuned default run, rows to scipy, its kernel launched and no index
built after ``prepare_sharded`` (the handle's dense operand handed over,
no second copy); then ``apsp(mesh=)`` per semiring and
``centrality(mesh=)`` on 128 sources, a ``GraphService(mesh=)`` on 512
queries of stream A's recipe, and a job killed after its second chunk and
resumed on ``mesh_from_plan(plan_remesh(1, model_parallel=1))``.  Phase
``sharded_blocks`` holds what ranks of a vertex-sharded mesh run: K1,
K5, K7 and K9 on C = 2 K-row blocks (and parts of the lanes) of rmat16
after 2 sweeps from all 1,024 sources (a (1, 2) rank's rows, eight
128-row tiles), each with its block's index, bit for bit to its plain
version, and the blocks' OR / SUM / MIN to the full operand's call
(comparisons: their launches do not count).  Then the rest of the
package's surface.  Phase ``io``: rmat16 written to disk with
``save_mtx``, as a ``symmetric`` pattern file (its 910,200 ``src < dst``
entries, written here), as a 1-indexed edge list, and with its lane
weights through ``save_mtx(weights=)`` and ``save_edgelist(weights=)``;
each read back onto the card with ``load_mtx`` / ``load_edgelist`` and
held to the in-memory graph, CSR arrays and lane weights bit for bit (an
edge list carries no node count, so it holds the nodes up to the largest
id with an edge: rmat16's isolated tail drops off, and the runs on it
compare that range); then ``prepare(loaded).apsp`` default, pinned push
(K1), pinned pull (K2) and fused (K3) on the general file, the tropical
default (K9) and pinned dense (K7) on the weighted one and the tropical
default on the weighted edge list, each ``dist`` equal to the in-memory
graph's run; save, load and apsp seconds apart.  Phase ``suite``: every
graph of ``configs.dawn.GRAPH_SUITE`` on the card, the default
``apsp`` over ``min(SOURCE_SET_SIZE, n)`` seeded sources, every row equal
to scipy's BFS.  Phase ``sample``: ``sample_subgraph`` on rmat16 from its
1,024 sources with GraphSAGE's fanouts (25, 10) and a CUDA generator,
every sampled id checked on the host to be an out-neighbour of its parent
(or the parent at degree 0), and ``sampled_batch``'s shapes.  Phase
``train``: a bigram model with a stacked (L, d, d) leaf over
``lm_iterator`` batches through ``make_train_step`` / ``train`` on the
card: AdamW, Adafactor and SGD make the loss fall, ``accum=4`` equals
``accum=1`` within rtol 1e-5 / atol 1e-6, a ``CheckpointHook`` run
restored and resumed equals the unbroken run bit for bit, int8 / top-k
compression equals the CPU bit for bit, and ``shard_batch``,
``make_jitted_step`` and ``make_cross_pod_psum`` run on a world-size-1
NCCL ``(pod, data, model)`` mesh.  Last, phase ``examples``: the
user examples, each ``examples/torch_*.py``'s ``main`` called in this
process on the card, its printed lines captured and its own asserts
held: the quickstart, the APSP engine with the serving loop, the
analytics driver at its default and at ``--scale 16 --sources 1024``
(rmat16's size), and the two mesh examples at world size 1 in one NCCL
group opened here, which they reuse (``torch_distributed_dawn`` pins
push and dense: K1 and K7 must launch).  The launch counts are set to 0
before each of these nine paths and read after; the io path must launch
K1, K2, K3, K7 and K9.
Each kernel line carries its launches on every path
(``launches_by_path``) and their sum (``launches``).
One JSON line per phase; the last line is
``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero.  Without CUDA, or
outside a checkout of the repository, it exits non-zero at once.

Graphs:
  rmat16   Graph500 RMAT parameters (A=0.57, B=0.19, C=0.19, edge factor
           16), undirected, seed 1, cut to scale 16 so the dense packed
           operand (n_pad^2 / 8 = 539 MB) fits one card; 1,024 sources.
  grid256  256 x 256 4-connected grid, road-like (diameter 510); 128
           sources.  Boolean only: its shortest-path counts run far past
           float32's 3.4e38 (phase ``grid256_counts`` prints a float64
           count), so the counting path runs on rmat16 alone, where every
           count stays below 2^24 (checked).

Weights: one per CSR lane, ``integers(4, 33) / 8`` from the script's
seed — dyadic values in [0.5, 4.0], the range ``bench_weighted`` draws
from, so every path sum is an exact float32 and the weighted distances
must EQUAL scipy's float64 Dijkstra.  The weighted runs take the same
sources as the boolean ones (1,024 on rmat16, 128 on grid256).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 1
N_CHECK = 16                 # sources checked against scipy per graph
N_CENTRALITY = 128           # sources of the centrality run
GRID_STEPS = 200             # sweeps before grid256's thin kernel state
GRID_RUN = 32                # sweeps per multi-sweep launch on that state
GRID_WRUN = 4                # K8's on the weighted one (its plain version
                             # reads the whole f32 operand every sweep)
EXACT_F32 = 2 ** 24          # float32 counts are exact integers below this
DYN_ROUNDS = 6               # update rounds of the dynamic phase
DYN_PER_ROUND = 6            # random pairs a round inserts (both ways)
DYN_SOURCES = 128            # sources of its repair runs
DYN_COMPACT_AFTER = 3        # the round after which the graph is compacted
# betweenness: float32 dependency sums (atomic scatter-adds in any order,
# a few thousand terms per hub) against a float64 Brandes on the host
BETWEENNESS_RTOL = 1e-5
# harmonic centrality: float32 sums of 1/d over <= 4096 terms per chunk,
# against a float64 sum on the host
HARMONIC_RTOL = 1e-5
SERVE_POOL = 96              # the serving streams' hot-source pool
SERVE_LANDMARKS = 16
SERVE_BATCH = 32             # max_batch and the handles' source_batch
SERVE_K = 8                  # k of the k-nearest queries
SERVE_QPS = 5000.0           # offered rate of the open loop (virtual)
SERVE_QUERIES = 10_000       # stream A
SERVE_WEIGHTED = 2_000       # stream B
SERVE_PUSH = 1_000           # stream C
SERVE_ANALYTICS = 64         # analytics queries after stream C
SERVE_EPOCH = 256            # queries on each side of the mutation
JOB_SOURCES = 512            # sources of the jobs phase
JOB_CHUNK = 128              # its chunk size
SHARDED_QUERIES = 512        # serving queries of the sharded phase
SHARDED_THRESHOLD = 16       # its flushes of at least this many: the mesh
SHARDED_BLOCK_ROWS = 1024    # source rows of the K-row block check: the
                             # whole shard of a (1, 2) mesh's rank
SAMPLE_FANOUTS = (25, 10)    # GraphSAGE's fanouts (the sample phase)
SAMPLE_FEAT = 100            # feature width of its sampled batch
TRAIN_VOCAB = 256            # the train phase's bigram model: vocabulary,
TRAIN_D = 64                 # width,
TRAIN_LAYERS = 2             # layers of its stacked (L, d, d) leaf,
TRAIN_BATCH = 32             # lm_iterator's global batch,
TRAIN_SEQ = 64               # sequence length,
TRAIN_STEPS = 20             # and steps per optimizer
TRAIN_RTOL = 1e-5            # accum=4 against accum=1 (float32 sums of
TRAIN_ATOL = 1e-6            # four microbatches in another order)

# the user examples (the examples phase), each main() as a user runs it,
# on the card: graph_analytics also at rmat16's size
EXAMPLES = (("torch_quickstart", ()), ("torch_apsp_engine", ()),
            ("torch_graph_analytics", ()),
            ("torch_graph_analytics", ("--scale", "16", "--sources",
                                       "1024")),
            ("torch_distributed_dawn", ()), ("torch_resumable_job", ()))
MESH_EXAMPLES = ("torch_distributed_dawn", "torch_resumable_job")

# float32 running sum of degrees over <= ~1,000 per-sweep partial sums,
# each a tree reduction of < 2^24-exact terms: relative error stays
# below (1,000 + 24) * 2^-24 ~ 6.1e-5
EDGES_RTOL = 1e-4

# least time the card could take (H100 SXM data sheet, dense rates at the
# 700 W limit): HBM bytes/s, int8 tensor-core ops/s, and 32-bit word
# ops/s — word logic or f32 adds (the float32 instruction rate, 67
# TFLOP/s counting an FMA as two operations)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
WORD_OPS_PER_S = 33.5e12

REPLACES = {
    "packed_push_sweep": "src/repro/kernels/bovm/kernel.py:249",
    "packed_pull_sweep": "src/repro/kernels/bovm/kernel.py:184",
    "fused_boolean_multisweep": "src/repro/kernels/bovm/kernel.py:343",
    "fused_sweep": "src/repro/kernels/bovm/kernel.py:116",
    "fused_counting_sweep": "src/repro/kernels/counting/kernel.py:103",
    "fused_counting_multisweep": "src/repro/kernels/counting/kernel.py:184",
    "fused_minplus_sweep": "src/repro/kernels/tropical/kernel.py:128",
    "fused_minplus_multisweep": "src/repro/kernels/tropical/kernel.py:210",
    "sparse_relax_sweep": "src/repro/kernels/tropical/kernel.py:302",
    # the index builders serve the ports of K1 / K2, K5 / K6, K7 / K8
    # and K9
    "packed_live_words": "src/repro/kernels/bovm/kernel.py:184",
    "nonzero_words": "src/repro/kernels/counting/kernel.py:184",
    "finite_words": "src/repro/kernels/tropical/kernel.py:128",
    "in_lanes": "src/repro/kernels/tropical/kernel.py:302",
    # XLA fuses the frontier's pack into the jitted sweep on the TPU
    "pack_frontier": "none (src/repro/core/frontier.py:24 pack_bits, "
                     "fused by XLA)",
}
# the frontier packer's shapes: (rows, n, row stride); a stride above n is
# a K-row rank's column slice of the (1,024, 1,049,088) state on the mesh
PACK_SHAPES = ((128, 262_272, 262_272), (1024, 262_272, 1_049_088),
               (1024, 1_049_088, 1_049_088))
PACK_REPS = 20
MULTI_SWEEP_NOTE = "no single PyTorch call computes a multi-sweep block"


def emit(**fields):
    print(json.dumps(fields), flush=True)


def tally(by_graph, graph, kernels, before):
    """Add each kernel's launches since ``before`` to its count on
    ``graph``; return them by name."""
    got = {k.__name__: k.launches - b for k, b in zip(kernels, before)}
    for name, c in got.items():
        by_graph.setdefault(name, {}).setdefault(graph, 0)
        by_graph[name][graph] += c
    return got


def launch_counts(kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def launched_since(kernels, before) -> dict:
    """Each kernel's launches since ``before`` (a ``launch_counts``), the
    kernels that launched only."""
    return {k: v - before[k] for k, v in launch_counts(kernels).items()
            if v != before[k]}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call unless ``warm`` is False."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of ``fn``'s launches alone (CUDA events around replays
    of one call captured in a CUDA graph): where the host takes longer to
    issue a call than the card to run it, ``cuda_ms`` times the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, reps)


def pack_rows(torch, bovm, pack_bits, source):
    """``pack_frontier`` at the cells' shapes against its bytes bound (R n
    bytes read, R ceil(n / 32) words written, once) and the plain
    ``pack_bits``: bit for bit, then timed warm (the input left in L2 by
    the last launch, as K1's output is in a sweep; ``device_ms`` one call
    replayed from a CUDA graph, the card's time without the host's) and
    cold (L2 emptied by a read of 256 MB before each launch: a read, so
    that no dirty line is written back during the launch).  On an empty
    card, before the graphs."""
    flush = torch.ones(256 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for r, n, ld in PACK_SHAPES:
        state = torch.rand((r, ld), device="cuda") < 0.05
        state[0] = True                          # all set: bit 31 the sign
        x = state.to(torch.int8)[:, :n]
        del state
        got = bovm.pack_frontier(x)
        if not torch.equal(got, pack_bits(x)):
            raise AssertionError(f"pack_frontier: {r} x {n} (stride {ld}) "
                                 f"differs from pack_bits")
        cold = 0.0
        for _ in range(PACK_REPS):
            flush.amax()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            bovm.pack_frontier(x)
            end.record()
            torch.cuda.synchronize()
            cold += start.elapsed_time(end)
        bytes_ = r * n + 4 * r * got.shape[1]
        rows.append(dict(
            name="pack_frontier", route="cuda", source=source,
            replaces=REPLACES["pack_frontier"], max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: bovm.pack_frontier(x), PACK_REPS),
            device_ms=graph_ms(torch, lambda: bovm.pack_frontier(x),
                               PACK_REPS),
            cold_ms=cold / PACK_REPS,
            plain_ms=cuda_ms(torch, lambda: pack_bits(x), 3),
            bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None, match=True,
            state=f"{r} x {n} int8 frontier, row stride {ld}",
            shape=dict(rows=r, n=n, row_stride=ld, words=got.shape[1]),
            library_note="no single PyTorch call packs bits into words"))
        del x, got
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return rows


def scipy_dist(g, sources) -> np.ndarray:
    from scipy.sparse.csgraph import shortest_path
    d = shortest_path(g.to_scipy(), unweighted=True, indices=sources)
    return np.where(np.isinf(d), -1, d).astype(np.int32)


def host_counts(g, sources):
    """Level-synchronous BFS with shortest-path counts in float64 on the
    host (scipy): (dist int32 (S, n), sigma float64 (S, n))."""
    at = g.to_scipy().T.tocsr().astype(np.float64)      # at[j, k] = A[k, j]
    n, s = g.n_nodes, len(sources)
    cols = np.arange(s)
    dist = np.full((n, s), -1, np.int64)
    sigma = np.zeros((n, s))
    dist[sources, cols] = 0
    sigma[sources, cols] = 1.0
    front, level = sigma.copy(), 0
    while True:
        level += 1
        cand = at @ front
        new = (cand > 0) & (dist < 0)
        if not new.any():
            break
        dist[new] = level
        sigma[new] = cand[new]
        front = np.where(new, cand, 0.0)
    return dist.T.astype(np.int32), sigma.T


def host_betweenness(g, sources, dist, sigma):
    """Source-restricted Brandes betweenness in float64 on the host, level
    by level: delta[u] += sigma[u] / sigma[v] * (1 + delta[v]) over edges
    u -> v one level apart."""
    a = g.to_scipy().tocsr().astype(np.float64)         # a[u, v]: u -> v
    delta = np.zeros_like(sigma)
    for t in range(int(dist.max()), 0, -1):
        coeff = np.where(dist == t, (1.0 + delta) / np.maximum(sigma, 1.0),
                         0.0)
        delta += np.where(dist == t - 1, sigma * (a @ coeff.T).T, 0.0)
    bc = delta.sum(axis=0)
    np.subtract.at(bc, sources, delta[np.arange(len(sources)), sources])
    return bc


def scipy_dijkstra(g, lanes, sources) -> np.ndarray:
    """Directed float64 Dijkstra over the lane weights (scipy)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    src, dst = g.edge_arrays_np()
    mat = sp.csr_matrix((lanes[: g.n_edges].astype(np.float64), (src, dst)),
                        shape=(g.n_nodes, g.n_nodes))
    return dijkstra(mat, directed=True, indices=sources)


def host_minplus(g, lanes, sources):
    """Frontier-gated Bellman-Ford in float32 on the host (numpy): the
    sweeps the tropical engine runs, replayed without the port.  Each
    sweep relaxes the out-lanes of the improved set with one float32 add
    and a min-scatter.  Returns (dist float32 (S, n), sweeps executed
    including the last, empty one, and the degree sum of every sweep's
    frontier in float64 — the engine's ``edges_touched``)."""
    n = g.n_nodes
    indptr = g.indptr.cpu().numpy().astype(np.int64)
    dst = g.dst[: g.n_edges].cpu().numpy().astype(np.int64)
    w = lanes[: g.n_edges]
    deg = np.diff(indptr)
    s = len(sources)
    dist = np.full((s, n), np.inf, np.float32)
    dist[np.arange(s), sources] = 0.0
    front = dist == 0.0
    sweeps, touched = 0, 0.0
    while sweeps < n:
        rows, nodes = np.nonzero(front)
        cnt = deg[nodes]
        touched += float(cnt.sum())
        lane = np.repeat(indptr[nodes] - (np.cumsum(cnt) - cnt), cnt) \
            + np.arange(int(cnt.sum()))
        cand = np.repeat(dist[rows, nodes], cnt) + w[lane]
        flat = dist.ravel().copy()
        np.minimum.at(flat, np.repeat(rows, cnt) * n + dst[lane], cand)
        nd = flat.reshape(s, n)
        front = nd < dist
        dist = nd
        sweeps += 1
        if not front.any():
            break
    return dist, sweeps, touched


def record_stream(n, rounds, per_round, seed):
    """The update stream of ``benchmarks/bench_dynamic.py``
    (``_record_stream``), copied: each round one 32-node index window,
    ``per_round`` random pairs inserted in both directions, and the
    shortcuts of two rounds earlier deleted.  Each insert also draws a
    lane weight, ``integers(4, 33) / 8`` from a second generator, so the
    pairs are bench_dynamic's own.  -> [(ins_src, ins_dst, ins_w,
    del_src, del_dst)]"""
    rng = np.random.default_rng(seed)
    wrng = np.random.default_rng(seed + 1)
    batches, history = [], []
    for _ in range(rounds):
        center = int(rng.integers(0, n))
        lo, hi = max(0, center - 16), min(n, center + 16)
        u = rng.integers(lo, hi, size=per_round)
        v = rng.integers(lo, hi, size=per_round)
        keep = u != v
        u, v = u[keep], v[keep]
        ins_src = np.concatenate([u, v]).astype(np.int64)   # undirected
        ins_dst = np.concatenate([v, u]).astype(np.int64)
        ins_w = (wrng.integers(4, 33, ins_src.size) / 8).astype(np.float32)
        if len(history) >= 2:
            del_src, del_dst = history.pop(0)
        else:
            del_src = del_dst = np.zeros(0, np.int64)
        history.append((ins_src, ins_dst))
        batches.append((ins_src, ins_dst, ins_w, del_src, del_dst))
    return batches


def k9_view_check(torch, tropical, what, dg, inc, seed):
    """One K9 sweep over the dynamic graph's current view (``m_pad`` its
    buffer capacity, tombstoned lanes at +inf) and the in-lane index
    the repair read, held bit-identical to the plain version.  The state
    is the repaired one with a seeded quarter of its reached non-source
    entries reset to +inf, relaxed from every entry still reached, so the
    sweep lowers entries again.  The launch is a comparison's and is not
    counted."""
    view = dg.view()
    n, n_pad = view.n_nodes, view.n_padded(128)
    lw = torch.from_numpy(dg.view_weights()).cuda() if dg.weighted \
        else torch.where(view.src < n, 1.0, float("inf")).to(torch.float32)
    d = torch.full((inc.dist.shape[0], n_pad), float("inf"),
                   dtype=torch.float32, device="cuda")
    d[:, :n] = inc.dist
    gen_ = torch.Generator(device="cuda").manual_seed(seed)
    cut = (torch.rand(d.shape, generator=gen_, device="cuda") < 0.25) \
        & (d > 0) & torch.isfinite(d)
    d = torch.where(cut, float("inf"), d)
    f = torch.isfinite(d).to(torch.int8)
    launches = tropical.sparse_relax_sweep.launches
    got = tropical.sparse_relax_sweep(f, d, view.src, view.dst, lw,
                                      index=inc.lane_index())
    tropical.sparse_relax_sweep.launches = launches
    want = tropical.sparse_relax_ref(f, d, view.src, view.dst, lw)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{what}: K9 over the view differs from its "
                             f"plain version")
    if not bool(want[0].any()):
        raise AssertionError(f"{what}: the K9 check lowered nothing")


def dynamic_run(torch, repro_torch, tropical, name, g, sources, lanes,
                stream):
    """One graph's update stream through the facade: each round mutates
    ``prepare(dg)``, repairs through ``h.incremental(sources).update()``
    (K9 resumes the sweep from the affected frontier) and holds the
    repaired ``dist`` and ``parent`` equal to a fresh ``sssp_state`` of the
    mutated graph.  Since that scratch run is K9 too where the default
    engine picks the sparse form, each round also holds one K9 sweep at
    the repaired view's shapes, over the index the repair read, against
    its plain version (:func:`k9_view_check`).  The graph is compacted
    once, after round ``DYN_COMPACT_AFTER``.  Ends with every source's
    row against scipy, directly and through the facade.  Returns the
    phase line's fields."""
    weighted = lanes is not None
    sparse, in_lanes = tropical.sparse_relax_sweep, tropical.in_lanes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    peak = 0
    t0 = time.perf_counter()
    dg = repro_torch.DynamicCSRGraph(g, weights=lanes,
                                     compact_threshold=0.001)
    h = repro_torch.prepare(dg)
    inc = h.incremental(sources)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    scratch_sweeps = inc.scratch_sweeps
    view_s = repair_s = scratch_s = 0.0
    k9 = lanes_built = 0
    views, rounds = set(), []
    for r, (ins_src, ins_dst, ins_w, del_src, del_dst) in enumerate(
            stream, 1):
        h.insert_edges(ins_src, ins_dst, ins_w if weighted else None)
        if del_src.size:
            h.delete_edges(del_src, del_dst)
        t0 = time.perf_counter()
        dg.view()
        view_s += time.perf_counter() - t0
        before = (sparse.launches, in_lanes.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inc.update()
        torch.cuda.synchronize()
        repair_s += time.perf_counter() - t0
        k9 += sparse.launches - before[0]
        lanes_built += in_lanes.launches - before[1]
        views.add((dg.epoch, dg.layout_version))
        # the comparison's allocations stay out of the peak
        peak = max(peak, torch.cuda.max_memory_allocated())
        k9_view_check(torch, tropical, f"dynamic/{name}: round {r}", dg,
                      inc, SEED + r)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        shadow, sweeps = repro_torch.sssp_state(dg, sources,
                                                config=inc.config)
        torch.cuda.synchronize()
        scratch_s += time.perf_counter() - t0
        scratch_sweeps += sweeps
        if not (torch.equal(inc.dist, shadow.dist)
                and torch.equal(inc.parent, shadow.parent)):
            raise AssertionError(f"dynamic/{name}: round {r}: the repaired "
                                 f"state differs from scratch")
        rounds.append(dict(round=r, epoch=dg.epoch, sweeps=res.sweeps,
                           tainted=res.tainted, seeded=res.seeded,
                           scratch_sweeps=sweeps))
        del shadow, res
        if r == DYN_COMPACT_AFTER:
            # same content: the facade keeps its prepared graphs
            pg = h.prepared()
            pw = h.prepared_weighted() if weighted else None
            layout = dg.layout_version
            h.compact()
            if dg.layout_version != layout + 1 or h.prepared() is not pg \
                    or (weighted and h.prepared_weighted() is not pw):
                raise AssertionError(f"dynamic/{name}: a compaction "
                                     f"rebuilt the prepared graph")
            del pg, pw
    if not inc.repair_sweeps < scratch_sweeps:
        raise AssertionError(f"dynamic/{name}: repair took "
                             f"{inc.repair_sweeps} sweeps, scratch "
                             f"{scratch_sweeps}")
    if k9 < 1:
        raise AssertionError(f"dynamic/{name}: K9 never launched in the "
                             f"repairs")
    if lanes_built != len(views) or len(views) != len(stream):
        raise AssertionError(f"dynamic/{name}: in_lanes built "
                             f"{lanes_built} times over {len(views)} "
                             f"repaired views")
    # the final graph against scipy, and through the facade
    view, check = dg.view(), sources
    if weighted:
        want = scipy_dijkstra(view, dg.view_weights(), check)
        got = inc.dist.cpu().numpy().astype(np.float64)
        res = h.apsp(check, semiring="tropical")
        facade = res.dist.cpu().numpy().astype(np.float64)
        epoch = h.prepared_weighted().epoch
    else:
        want = scipy_dist(view, check)
        got = inc.dist_int().cpu().numpy()
        res = h.apsp(check)
        facade = res.dist.cpu().numpy()
        epoch = h.prepared().epoch
    if not (np.array_equal(got, want) and np.array_equal(facade, want)):
        raise AssertionError(f"dynamic/{name}: the final graph's rows "
                             f"differ from scipy")
    if epoch != dg.epoch:
        raise AssertionError(f"dynamic/{name}: prepared at epoch {epoch}, "
                             f"the graph is at {dg.epoch}")
    return dict(graph=name, weighted=weighted, sources=int(len(sources)),
                n_rounds=len(stream), repair_sweeps=inc.repair_sweeps,
                scratch_sweeps=scratch_sweeps, n_epochs=dg.epoch,
                n_compactions=dg.compactions, repairs=inc.repairs,
                rebuilds=inc.rebuilds, k9_launches_in_repairs=k9,
                in_lanes_launches_in_repairs=lanes_built,
                repaired_views=len(views), repair_seconds=repair_s,
                scratch_seconds=scratch_s, view_seconds=view_s,
                setup_seconds=setup_s, m_pad=view.m_pad,
                live_lanes=view.n_edges,
                max_memory_allocated=max(
                    peak, torch.cuda.max_memory_allocated()),
                rows_checked=int(len(check)), k9_view_checks=len(stream),
                rounds=rounds)


class VirtualClock:
    """The serving phase's clock: an arrival sets it forward to its
    scheduled instant, and each submit / tick / flush advances it by that
    call's measured host time (``bench_serving``'s open loop)."""

    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def serve_stream(n, n_queries, seed, mix):
    """``bench_serving``'s workload recipe (``_make_stream``), copied: a
    Zipf-hot pool of ``SERVE_POOL`` sources, uniform targets, query kinds
    drawn with probabilities ``mix`` (point-to-point, k-nearest, full
    row) and Poisson arrivals at ``SERVE_QPS``.  -> (pool,
    [(kind, source, target)], arrivals)"""
    rng = np.random.default_rng(seed)
    pool = rng.choice(n, size=min(SERVE_POOL, n), replace=False)
    w = 1.0 / np.arange(1, len(pool) + 1)          # Zipf weights
    w /= w.sum()
    sources = rng.choice(pool, size=n_queries, p=w)
    targets = rng.integers(0, n, size=n_queries)
    kinds = rng.choice(3, size=n_queries, p=list(mix))
    arrivals = np.cumsum(rng.exponential(1.0 / SERVE_QPS, size=n_queries))
    return pool, list(zip(kinds.tolist(), sources.tolist(),
                          targets.tolist())), arrivals


def serve_drive(svc, query, stream, arrivals, clock, acc, weighted=False,
                qid0=0):
    """Open loop: submit at the scheduled virtual instants, ``tick()``
    after each arrival (size-threshold flushing only: no deadline, no
    ``max_wait``), drain with ``flush()``.  Adds the host seconds and the
    count of the flushes to ``acc``; returns the completed queries."""
    def timed(call):
        t0 = time.perf_counter()
        out = call()
        dt = time.perf_counter() - t0
        clock.now += dt
        return out, dt

    for i, ((kind, s, t), at) in enumerate(zip(stream, arrivals)):
        clock.now = max(clock.now, float(at))
        if kind == 0:
            q = query(qid=qid0 + i, source=s, target=t, weighted=weighted)
        elif kind == 1:
            q = query(qid=qid0 + i, source=s, k_nearest=SERVE_K)
        else:
            q = query(qid=qid0 + i, source=s, weighted=weighted)
        timed(lambda: svc.submit(q))
        while True:
            served, dt = timed(svc.tick)
            if not served:
                break
            acc["flush_seconds"] += dt
            acc["flushes"] += 1
    while svc.pending():
        _, dt = timed(svc.flush)
        acc["flush_seconds"] += dt
        acc["flushes"] += 1
    return svc.drain_completed()


def serve_check(what, done, rows, select_top_k):
    """Every completed answer against the host row of its source (scipy
    BFS int32 rows, or scipy Dijkstra float64 rows when weighted); a
    k-nearest list against ``select_top_k`` on that row, once per
    source."""
    nearest = {}
    for q in done:
        if q.expired:
            raise AssertionError(f"{what}: query {q.qid} expired in a "
                                 f"no-deadline run")
        row = rows[q.source]
        if q.target is not None:
            got = q.cost if q.weighted else q.hops
            if got != row[q.target]:
                raise AssertionError(f"{what}: query {q.qid} "
                                     f"({q.served_by}) {got} != "
                                     f"{row[q.target]}")
        elif q.k_nearest is not None:
            if q.source not in nearest:
                nearest[q.source] = select_top_k(row, q.source, q.k_nearest)
            if q.nearest != nearest[q.source]:
                raise AssertionError(f"{what}: query {q.qid} "
                                     f"({q.served_by}) k-nearest differs")
        elif not np.array_equal(q.dist.astype(row.dtype), row):
            raise AssertionError(f"{what}: query {q.qid} ({q.served_by}) "
                                 f"row differs")


def serve_kernel_check(torch, repro_torch, g, lanes, sources):
    """K1 and K9 at the serving flushes' shape (S = ``SERVE_BATCH``), each
    one sweep on a mid-run rmat16 state from serving sources, held
    bit-identical to its plain version.  K1 runs on the operand and
    live-word index of the pinned-push handle stream C serves, after
    ``mid_step`` engine sweeps; K9 on the weighted handle's lanes and
    in-lane index, after ``mid_step`` relax sweeps.  These launches are
    comparisons: the counts are put back as they were.  Returns the
    phase line's fields."""
    from repro_torch.core.engine import EngineConfig, apsp_engine_blocks
    from repro_torch.core.frontier import pack_bits
    from repro_torch.core.sweep import _pull_kernel_wk
    from repro_torch.kernels import bovm, tropical
    from repro_torch.kernels.bovm import ref as R
    from repro_torch.kernels.tropical import ref as TR
    mid_step = 2
    kernels = (bovm.packed_push_sweep, bovm.packed_live_words,
               tropical.sparse_relax_sweep, tropical.in_lanes)
    saved = [k.launches for k in kernels]
    try:
        pg = repro_torch.prepare(g, mode="push",
                                 source_batch=SERVE_BATCH).prepared()
        cfg = EngineConfig(mode="push", use_kernel=True, max_steps=mid_step,
                           source_batch=SERVE_BATCH)
        _, _, st = next(apsp_engine_blocks(pg, sources, config=cfg))
        fp, d = pack_bits(st.frontier != 0), st.dist.contiguous()
        at = pg.adj_pull
        got = bovm.packed_push_sweep(fp, at, d, mid_step + 1,
                                     bs=SERVE_BATCH, bn=cfg.bn,
                                     wk=_pull_kernel_wk(at.shape[1]),
                                     index=pg.adj_pull_index)
        want = R.packed_pull_ref(fp, at, d, mid_step + 1)
        if fp.shape[0] != SERVE_BATCH or not all(
                torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"serve: K1 at S={fp.shape[0]} differs "
                                 f"from its plain version")
        k1_new = int((want[0] != 0).sum())
        del pg, st, fp, d, got, want
        pw = repro_torch.prepare(g, weights=lanes).prepared_weighted()
        wg, lw, idx = pw.graph, pw.w_edges, pw.relax_index
        src = torch.from_numpy(np.asarray(sources, np.int64)).cuda()
        f = torch.zeros((len(src), pw.n_pad), dtype=torch.int8,
                        device="cuda")
        f[torch.arange(len(src), device="cuda"), src] = 1
        d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
        for _ in range(mid_step):
            f, d = tropical.sparse_relax_sweep(f, d, wg.src, wg.dst, lw,
                                               index=idx)
        got = tropical.sparse_relax_sweep(f, d, wg.src, wg.dst, lw,
                                          index=idx)
        want = TR.sparse_relax_ref(f, d, wg.src, wg.dst, lw)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"serve: K9 at S={len(src)} differs from "
                                 f"its plain version")
        k9_new = int((want[0] != 0).sum())
        del pw, f, d, got, want
    finally:
        for k, c in zip(kernels, saved):
            k.launches = c
    if not (k1_new and k9_new):
        raise AssertionError("serve: a kernel check discovered nothing")
    torch.cuda.empty_cache()
    return dict(sources=len(sources), state=f"after {mid_step} sweeps",
                k1_discovered=k1_new, k9_lowered=k9_new,
                max_abs_err=0.0)


def serve_run(torch, repro_torch, all_kernels, g, lanes):
    """The serving tier through ``prepare(rmat16, weights=w).serve(...)``
    under a virtual clock: stream A (bench_serving's mix, 60 %
    point-to-point, 20 % k-nearest, 20 % full rows, over the landmark
    oracle and the row cache), stream B (weighted, 60 % point-to-point,
    40 % full rows: K9 flushes), stream C (a pinned-push handle with no
    oracle, every miss a K1 flush) plus analytics queries, the epoch guard
    over a mutated ``DynamicCSRGraph``, and a deadline run.  Returns one
    line of fields per stream."""
    import repro_torch.serve.engine as serve_engine
    from collections import defaultdict
    from repro_torch.serve import select_top_k
    GraphQuery = repro_torch.GraphQuery
    n = g.n_nodes
    lines = []

    def counts():
        return {k.__name__: k.launches for k in all_kernels}

    def launched(before):
        return {k: v - before[k] for k, v in counts().items()
                if v != before[k]}

    acc = defaultdict(float)

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t0
        return wrapper

    plain_top_k = serve_engine.select_top_k
    serve_engine.select_top_k = timed(plain_top_k, "select_top_k_seconds")
    try:
        # -- stream A and B: one weighted service -----------------------
        clock = VirtualClock()
        h = repro_torch.prepare(g, weights=lanes, source_batch=SERVE_BATCH)
        svc = h.serve(max_batch=SERVE_BATCH, n_landmarks=SERVE_LANDMARKS,
                      row_cache_size=SERVE_POOL, completed_retention=None,
                      clock=clock)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oracle = svc.oracle                      # the label build
        torch.cuda.synchronize()
        label_s = time.perf_counter() - t0
        label_launches = launched(before)
        for name in ("query", "top_k", "landmark_row", "predicted_sweeps"):
            setattr(oracle, name, timed(getattr(oracle, name),
                                        "oracle_seconds"))
        pool, stream, arrivals = serve_stream(n, SERVE_QUERIES, SEED + 10,
                                              (0.6, 0.2, 0.2))
        acc.clear()
        before = counts()
        t0 = time.perf_counter()
        done = serve_drive(svc, GraphQuery, stream, arrivals, clock, acc)
        wall = time.perf_counter() - t0
        got_launches = launched(before)
        rows = dict(zip(pool.tolist(), scipy_dist(g, pool)))
        serve_check("serve/A", done, rows, select_top_k)
        if len(done) != SERVE_QUERIES:
            raise AssertionError(f"serve/A: {len(done)} answers")
        # certified count: the stream replayed on a bare oracle, which
        # shares the service's label tables (cached on the same prepared
        # graph) and only drops the timing wrappers (a source's top-k
        # certificate is a function of the source: asked once per source)
        bare = repro_torch.DistanceOracle(svc.prepared,
                                          n_landmarks=SERVE_LANDMARKS)
        certified, topk = 0, {}
        for kind, s, t in stream:
            if kind == 0:
                certified += bool(bare.query(s, t).exact)
            elif kind == 1:
                if s not in topk:
                    topk[s] = bare.top_k(s, SERVE_K) is not None
                certified += topk[s]
            else:
                certified += bare.landmark_row(s) is not None
        lat = np.asarray([q.t_done - q.t_submit for q in done])
        hits = svc.cache_hits + svc.oracle_hits
        lines.append(dict(
            stream="A", queries=len(done), pool=len(pool),
            n_landmarks=oracle.n_landmarks,
            labels_checksum=oracle.labels_checksum(),
            certified_count=int(certified),
            certified_fraction=certified / len(done),
            hit_rate=hits / len(done), cache_hits=svc.cache_hits,
            oracle_hits=svc.oracle_hits, sweep_served=svc.sweep_served,
            flushes=int(acc["flushes"]), flush_seconds=acc["flush_seconds"],
            oracle_seconds=acc["oracle_seconds"],
            select_top_k_seconds=acc["select_top_k_seconds"],
            label_build_seconds=label_s, label_launches=label_launches,
            seconds=wall, p50_latency_us=float(np.percentile(lat, 50) * 1e6),
            p99_latency_us=float(np.percentile(lat, 99) * 1e6),
            launches=got_launches, checked=len(done)))
        # stream B: weighted queries on the same service
        pool_b, stream_b, arr_b = serve_stream(n, SERVE_WEIGHTED, SEED + 11,
                                               (0.6, 0.0, 0.4))
        arr_b = arr_b + clock.now
        acc.clear()
        hits0 = (svc.cache_hits, svc.sweep_served)
        before = counts()
        t0 = time.perf_counter()
        done = serve_drive(svc, GraphQuery, stream_b, arr_b, clock, acc,
                           weighted=True, qid0=SERVE_QUERIES)
        wall = time.perf_counter() - t0
        got_launches = launched(before)
        if got_launches.get("sparse_relax_sweep", 0) < 1:
            raise AssertionError("serve/B: no weighted flush launched K9")
        rows = dict(zip(pool_b.tolist(), scipy_dijkstra(g, lanes, pool_b)))
        serve_check("serve/B", done, rows, select_top_k)
        if len(done) != SERVE_WEIGHTED or not all(
                q.dist is None or q.dist.dtype == np.float32 for q in done):
            raise AssertionError("serve/B: answers missing or not float32")
        lines.append(dict(
            stream="B", queries=len(done), pool=len(pool_b),
            cache_hits=svc.cache_hits - hits0[0],
            sweep_served=svc.sweep_served - hits0[1],
            flushes=int(acc["flushes"]), flush_seconds=acc["flush_seconds"],
            seconds=wall, launches=got_launches, checked=len(done)))
        del svc, h, oracle, bare, done
        torch.cuda.empty_cache()

        # -- stream C: pinned push, no oracle; analytics -----------------
        clock = VirtualClock()
        h = repro_torch.prepare(g, mode="push", source_batch=SERVE_BATCH)
        svc = h.serve(max_batch=SERVE_BATCH, n_landmarks=0,
                      row_cache_size=SERVE_POOL, completed_retention=None,
                      clock=clock)
        pool_c, stream_c, arr_c = serve_stream(n, SERVE_PUSH, SEED + 12,
                                               (0.6, 0.2, 0.2))
        acc.clear()
        before = counts()
        t0 = time.perf_counter()
        done = serve_drive(svc, GraphQuery, stream_c, arr_c, clock, acc)
        wall = time.perf_counter() - t0
        got_launches = launched(before)
        if got_launches.get("packed_push_sweep", 0) < 1:
            raise AssertionError("serve/C: no pinned-push flush launched K1")
        rows_c = scipy_dist(g, pool_c)
        rows = dict(zip(pool_c.tolist(), rows_c))
        serve_check("serve/C", done, rows, select_top_k)
        line = dict(stream="C", queries=len(done), pool=len(pool_c),
                    cache_hits=svc.cache_hits, oracle_hits=svc.oracle_hits,
                    sweep_served=svc.sweep_served,
                    flushes=int(acc["flushes"]),
                    flush_seconds=acc["flush_seconds"],
                    select_top_k_seconds=acc["select_top_k_seconds"],
                    seconds=wall, launches=got_launches, checked=len(done))
        measures = ("closeness", "harmonic", "eccentricity")
        before = counts()
        t0 = time.perf_counter()
        for i, s in enumerate(pool_c[:SERVE_ANALYTICS].tolist()):
            svc.submit(GraphQuery(qid=SERVE_PUSH + i, source=s,
                                  analytics=measures))
        while svc.pending():
            svc.flush()
        adone = svc.drain_completed()
        line.update(analytics_queries=len(adone),
                    analytics_seconds=time.perf_counter() - t0,
                    analytics_launches=launched(before))
        if len(adone) != SERVE_ANALYTICS:
            raise AssertionError(f"serve/C: {len(adone)} analytics answers")
        for q, d in zip(adone, rows_c[:SERVE_ANALYTICS]):
            reach = d > 0
            r, tot = int(reach.sum()), int(d[reach].sum())
            clo = (r / max(n - 1, 1)) * (r / tot) if tot > 0 else 0.0
            har = float((1.0 / d[reach]).sum())
            got = q.analytics_result
            if not (got["eccentricity"] == int(d.max(initial=0))
                    and np.isclose(got["closeness"], clo, rtol=1e-12,
                                   atol=0.0)
                    and np.isclose(got["harmonic"], har,
                                   rtol=HARMONIC_RTOL, atol=0.0)):
                raise AssertionError(f"serve/C: analytics of {q.source} "
                                     f"{got} differ from the host's "
                                     f"({clo}, {har})")
        lines.append(line)
        del svc, h, done, adone
        torch.cuda.empty_cache()

        # -- the epoch guard over a mutated DynamicCSRGraph ----------------
        clock = VirtualClock()
        dg = repro_torch.DynamicCSRGraph(g)
        h = repro_torch.prepare(dg, source_batch=SERVE_BATCH)
        svc = h.serve(max_batch=SERVE_BATCH, n_landmarks=SERVE_LANDMARKS,
                      row_cache_size=SERVE_POOL, completed_retention=None,
                      clock=clock)
        pool_e, stream_e, arr_e = serve_stream(n, 2 * SERVE_EPOCH,
                                               SEED + 13, (0.6, 0.2, 0.2))
        acc.clear()
        before = counts()
        t0 = time.perf_counter()
        first = serve_drive(svc, GraphQuery, stream_e[:SERVE_EPOCH],
                            arr_e[:SERVE_EPOCH], clock, acc)
        invalidations = svc.epoch_invalidations
        ins_src, ins_dst, _, del_src, del_dst = record_stream(
            n, 1, DYN_PER_ROUND, SEED + 13)[0]
        h.insert_edges(ins_src, ins_dst)
        if del_src.size:
            h.delete_edges(del_src, del_dst)
        done = serve_drive(svc, GraphQuery, stream_e[SERVE_EPOCH:],
                           arr_e[SERVE_EPOCH:] + clock.now, clock, acc,
                           qid0=SERVE_EPOCH)
        wall = time.perf_counter() - t0
        serve_check("serve/epoch before", first,
                    dict(zip(pool_e.tolist(), scipy_dist(g, pool_e))),
                    select_top_k)
        view = dg.view()
        serve_check("serve/epoch after", done,
                    dict(zip(pool_e.tolist(), scipy_dist(view, pool_e))),
                    select_top_k)
        if (invalidations, svc.epoch_invalidations) != (0, 1) or \
                svc.prepared.epoch != dg.epoch or dg.epoch != 1:
            raise AssertionError(
                f"serve/epoch: {svc.epoch_invalidations} invalidations, "
                f"prepared at epoch {svc.prepared.epoch}, graph at "
                f"{dg.epoch}")
        lines.append(dict(stream="epoch", queries=2 * SERVE_EPOCH,
                          inserted=int(ins_src.size),
                          epoch_invalidations=svc.epoch_invalidations,
                          epoch=dg.epoch,
                          labels_checksum=svc.oracle.labels_checksum(),
                          flushes=int(acc["flushes"]), seconds=wall,
                          launches=launched(before),
                          checked=len(done) + SERVE_EPOCH))
        del svc, h, dg, view, first, done
        torch.cuda.empty_cache()

        # -- a deadline run: expired queries are surfaced, not dropped -----
        clock = VirtualClock()
        svc = repro_torch.prepare(g, source_batch=8).serve(max_batch=8,
                                                           clock=clock)
        for i in range(4):
            svc.submit(GraphQuery(qid=i, source=int(pool[i]), target=n - 1,
                                  deadline=0.01))
        clock.now = 1.0
        svc.flush()
        done = svc.drain_completed()
        if len(done) != 4 or svc.expired_count != 4 or not all(
                q.expired and q.served_by == "expired" and q.hops is None
                for q in done):
            raise AssertionError("serve/deadline: expired queries were not "
                                 "surfaced")
        lines.append(dict(stream="deadline", queries=4,
                          expired=svc.expired_count))
        del svc
    finally:
        serve_engine.select_top_k = plain_top_k
    return lines


def jobs_run(torch, repro_torch, all_kernels, g, lanes, sources):
    """Resumable jobs through ``prepare(rmat16, ...).apsp(sources,
    semiring=..., checkpoint_dir=...)``: per workload a full run, a run
    killed by ``on_chunk`` after its second chunk, and its resumed run,
    held bit-identical to each other and to one ``apsp`` call without a
    checkpoint, rows held to scipy; then one CUDA leaf saved with
    ``blocking=False`` and overwritten at once.  Each of the three job
    runs must launch its workload's kernel; the plain ``apsp`` call is a
    comparison, and its launches are taken back out of the counts.
    Returns one line of fields per workload and one for the snapshot
    check."""
    import shutil
    import tempfile
    from repro_torch.train import checkpoint as ckpt

    def counts():
        return launch_counts(all_kernels)

    def launched(before):
        return launched_since(all_kernels, before)

    class Preempt(RuntimeError):
        pass

    def kill(k):
        if k == 1:
            raise Preempt(f"injected preemption after chunk {k}")

    check = sources[:: len(sources) // N_CHECK][:N_CHECK]
    rows = np.searchsorted(sources, check)
    want_dist, want_sigma = host_counts(g, check)
    want_w = scipy_dijkstra(g, lanes, check)
    runs = {"boolean": dict(mode="push"), "counting": dict(mode="push"),
            "tropical": {}}
    kernel_of = {"boolean": "packed_push_sweep",
                 "counting": "fused_counting_sweep",
                 "tropical": "sparse_relax_sweep"}
    lines = []
    root = tempfile.mkdtemp(prefix="chip_smoke_jobs_")
    try:
        for workload, opts in runs.items():
            h = repro_torch.prepare(
                g, weights=lanes if workload == "tropical" else None, **opts)
            kw = dict(semiring=workload, chunk_size=JOB_CHUNK,
                      checkpoint_interval=1)
            full_dir, kill_dir = (tempfile.mkdtemp(dir=root)
                                  for _ in range(2))
            per_run = {}
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = h.apsp(sources, checkpoint_dir=full_dir, **kw)
            full_s = time.perf_counter() - t0
            per_run["full"] = launched(before)
            before = counts()
            try:
                h.apsp(sources, checkpoint_dir=kill_dir, on_chunk=kill, **kw)
                raise AssertionError(f"jobs/{workload}: the kill did not "
                                     f"fire")
            except Preempt:
                pass
            per_run["killed"] = launched(before)
            before = counts()
            t0 = time.perf_counter()
            res = h.apsp(sources, checkpoint_dir=kill_dir, **kw)
            resume_s = time.perf_counter() - t0
            per_run["resumed"] = launched(before)
            for run, got in per_run.items():
                if got.get(kernel_of[workload], 0) < 1:
                    raise AssertionError(f"jobs/{workload}: the {run} run "
                                         f"never launched "
                                         f"{kernel_of[workload]}")
            # the plain call is a comparison: its launches do not count
            before = counts()
            single = h.apsp(sources, semiring=workload)
            for k in all_kernels:
                k.launches = before[k.__name__]
            if (res.chunks_restored, res.chunks_computed,
                    res.restored_step) != (2, 2, 2) or \
                    full.chunks_total != 4 or res.corrupt_skipped:
                raise AssertionError(
                    f"jobs/{workload}: resumed {res.chunks_restored} chunks "
                    f"from step {res.restored_step}, computed "
                    f"{res.chunks_computed}")
            one = dict(dist=single.dist.cpu().numpy(), sweeps=single.sweeps,
                       direction_counts=single.direction_counts.numpy(),
                       sigma=single.sigma.cpu().numpy()
                       if workload == "counting" else None,
                       edges_touched=float(single.edges_touched)
                       if workload != "counting" else 0.0)
            want = full._asdict()
            for what, got in (("resumed", res._asdict()),
                              ("single call", one)):
                same = got["dist"].dtype == want["dist"].dtype and all(
                    np.array_equal(got[k], want[k]) if k in (
                        "dist", "sigma", "direction_counts")
                    else got[k] == want[k] for k in one)
                if not same:
                    raise AssertionError(f"jobs/{workload}: the {what} "
                                         f"differs from the full run")
            if workload == "tropical":
                ok = np.array_equal(full.dist[rows].astype(np.float64),
                                    want_w)
            else:
                ok = np.array_equal(full.dist[rows], want_dist) and (
                    workload == "boolean" or np.array_equal(
                        full.sigma[rows].astype(np.float64), want_sigma))
            if not ok:
                raise AssertionError(f"jobs/{workload}: rows differ from "
                                     f"the host's")
            step = ckpt.latest_step(full_dir)
            step_dir = Path(full_dir) / f"step_{step:09d}"
            ckpt_bytes = sum(p.stat().st_size for p in step_dir.iterdir())
            like = {"dist": full.dist, "sigma": full.sigma
                    if full.sigma is not None else np.zeros((1, 1),
                                                            np.float32),
                    "sweeps": 0, "dir_counts": full.direction_counts,
                    "edges_touched": 0.0, "chunks_done": 0}
            t0 = time.perf_counter()
            state, _ = ckpt.restore(full_dir, step, like)
            restore_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ckpt.save(tempfile.mkdtemp(dir=root), step, state, keep=1)
            save_s = time.perf_counter() - t0
            lines.append(dict(
                workload=workload, options=opts, sources=len(sources),
                chunk_size=JOB_CHUNK, chunks_total=full.chunks_total,
                full_seconds=full_s, resumed_seconds=resume_s,
                chunks_restored=res.chunks_restored,
                chunks_computed=res.chunks_computed,
                restored_step=res.restored_step, sweeps=full.sweeps,
                direction_counts=full.direction_counts.tolist(),
                edges_touched=full.edges_touched,
                checkpoints_written=full.checkpoints_written,
                checkpoint_bytes=ckpt_bytes,
                checkpoint_save_seconds=save_s,
                checkpoint_restore_seconds=restore_s,
                kept_steps=ckpt.all_steps(full_dir),
                launches=per_run, rows_checked=int(len(check))))
            del h, full, res, single, one, want, got, state
            for d in Path(root).iterdir():
                shutil.rmtree(d)
            torch.cuda.empty_cache()
        # the async snapshot of a CUDA leaf completes before save returns
        leaf = torch.arange(1 << 24, dtype=torch.float32, device="cuda")
        want = leaf.cpu().numpy().copy()
        t0 = time.perf_counter()
        t = ckpt.save(root, 1, {"x": leaf}, blocking=False)
        submit_s = time.perf_counter() - t0
        leaf.fill_(-1.0)
        t.join()
        got, _ = ckpt.restore(root, 1, {"x": leaf})
        if not np.array_equal(got["x"], want):
            raise AssertionError("jobs: a CUDA leaf overwritten after an "
                                 "async save restored torn")
        lines.append(dict(workload="snapshot", leaf_bytes=int(want.nbytes),
                          submit_seconds=submit_s, restored_equal=True))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return lines


def tune_run(torch, repro_torch, all_kernels, graphs, lanes_of, srcs,
             untuned, seconds_of, cent_base):
    """The roofline autotuner on the card: per graph, ``h.tune(save=...)``
    on ``prepare(g, weights=lanes)`` twice (the same checksum, op-count
    costs for every semiring, finite and positive), the saved plan loaded
    back (equal; a copy for another device refused unless
    ``allow_mismatch=True``), then the tuned default runs through
    ``prepare(g, tuning=path, weights=lanes)`` twice each — boolean,
    counting (rmat16 only: grid256's counts overflow float32) and
    tropical, and on rmat16 ``centrality`` on ``N_CENTRALITY`` sources —
    held bit for bit to the untuned default runs of the earlier phases
    (``untuned``: host dist, sigma, sweeps; ``cent_base``: the centrality
    result, its float measures to their rtol), with equal
    ``direction_counts`` across the two runs.  Yields one line of fields
    per plan and per tuned run."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.core import autotune

    def counts():
        return launch_counts(all_kernels)

    def launched(before):
        return launched_since(all_kernels, before)

    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        for name, g in graphs.items():
            lanes = lanes_of[name]
            path = str(Path(root) / f"{name}.json")
            plans, build_s, peaks = [], [], []
            for _ in range(2):
                h = repro_torch.prepare(g, weights=lanes)
                h.prepared()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                plans.append(h.tune(save=path))
                torch.cuda.synchronize()
                build_s.append(time.perf_counter() - t0)
                peaks.append(torch.cuda.max_memory_allocated())
                del h
                torch.cuda.empty_cache()
            plan = plans[0]
            if plans[1] != plan or plans[1].checksum() != plan.checksum():
                raise AssertionError(f"tune/{name}: two builds differ")
            if plan.source != "ops" or not all(
                    plan.covers(sr) for sr in autotune.FORM_VOCAB):
                raise AssertionError(f"tune/{name}: source {plan.source!r}, "
                                     f"not every semiring priced")
            if not all(np.isfinite(c) and c > 0
                       for _, _, c in plan.unit_costs):
                raise AssertionError(f"tune/{name}: a unit cost is not "
                                     f"finite and positive")
            loaded = repro_torch.TuningPlan.load(path, device="cuda")
            if loaded != plan:
                raise AssertionError(f"tune/{name}: the loaded plan differs")
            alien_path = str(Path(root) / f"{name}-alien.json")
            alien = dataclasses.replace(plan, backend="cuda:another card")
            alien.save(alien_path)
            try:
                repro_torch.TuningPlan.load(alien_path, device="cuda")
                raise AssertionError(f"tune/{name}: a plan for another "
                                     f"device loaded")
            except ValueError:
                pass
            if repro_torch.TuningPlan.load(alien_path, allow_mismatch=True,
                                           device="cuda") != alien:
                raise AssertionError(f"tune/{name}: allow_mismatch load")
            st = plan.graph
            relative = {sr: {f: plan.unit_cost(sr, f)
                             / plan.unit_cost(sr, vocab[0])
                             for f in vocab}
                        for sr, vocab in autotune.FORM_VOCAB.items()}
            yield dict(
                what="plan", graph=name, fingerprint=plan.backend,
                source=plan.source, checksum=plan.checksum(),
                unit_costs=[list(u) for u in plan.unit_costs],
                relative_costs=relative,
                pinned={sr: autotune.FORM_VOCAB[sr][plan.pinned_direction(
                    sr, s=128, n_pad=st.n_pad, m_pad=st.m_pad)]
                    for sr in autotune.FORM_VOCAB},
                bs=plan.bs, bn=plan.bn, bk=plan.bk,
                fused_steps=plan.fused_steps, vmem_budget=plan.vmem_budget,
                build_seconds=build_s, peak_memory_bytes=peaks,
                loaded_equal=True, foreign_refused=True)

            semirings = ("boolean", "counting", "tropical") \
                if name == "rmat16" else ("boolean", "tropical")
            for semiring in semirings:
                dist0, sigma0, sweeps0 = untuned[(semiring, name)]
                runs, walls, per_run = [], [], []
                for _ in range(2):
                    h = repro_torch.prepare(g, tuning=path, weights=lanes)
                    if h.tuning != plan:
                        raise AssertionError(f"tune/{name}: prepare("
                                             f"tuning=path) lost the plan")
                    # operand builds are set-up, as in the earlier phases
                    if semiring == "tropical":
                        h.prepared_weighted().wdense_index
                    elif semiring == "counting":
                        h.prepared().adj_index
                    else:
                        h.prepared().adj_pull
                    before = counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = h.apsp(srcs[name], semiring=semiring)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                    per_run.append(launched(before))
                    del h
                    if not (torch.equal(res.dist.cpu(), dist0)
                            and res.sweeps == sweeps0
                            and (sigma0 is None
                                 or torch.equal(res.sigma.cpu(), sigma0))):
                        raise AssertionError(
                            f"tune/{name}/{semiring}: dist, sigma or sweeps "
                            f"differ from the untuned default run")
                    runs.append(res.direction_counts.tolist())
                    del res
                    torch.cuda.empty_cache()
                if runs[0] != runs[1]:
                    raise AssertionError(f"tune/{name}/{semiring}: "
                                         f"direction_counts differ: {runs}")
                yield dict(
                    what="run", graph=name, semiring=semiring,
                    sources=int(len(srcs[name])), seconds=walls,
                    untuned_default_seconds=seconds_of.get(
                        (semiring, name, "default")),
                    untuned_fused_seconds=seconds_of.get(
                        (semiring, name, "fused")),
                    sweeps=sweeps0, direction_counts=runs[0],
                    launches=per_run, equal_to_untuned_default=True)
            if name != "rmat16":
                continue
            csub = srcs[name][:N_CENTRALITY]
            walls, per_run = [], []
            for _ in range(2):
                h = repro_torch.prepare(g, tuning=path, weights=lanes)
                h.prepared().adj_index
                before = counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cent = h.centrality(csub)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                per_run.append(launched(before))
                del h
                exact = all(np.array_equal(getattr(cent, k),
                                           getattr(cent_base, k))
                            for k in ("closeness", "eccentricity")) and (
                    cent.radius, cent.diameter, cent.sweeps,
                    cent.sigma_checksum) == (
                    cent_base.radius, cent_base.diameter, cent_base.sweeps,
                    cent_base.sigma_checksum)
                close = np.allclose(cent.betweenness, cent_base.betweenness,
                                    rtol=BETWEENNESS_RTOL, atol=0.0) and \
                    np.allclose(cent.harmonic, cent_base.harmonic,
                                rtol=HARMONIC_RTOL, atol=0.0)
                if not (exact and close):
                    raise AssertionError(f"tune/{name}/centrality: differs "
                                         f"from the untuned run")
                torch.cuda.empty_cache()
            yield dict(
                what="run", graph=name, semiring="centrality",
                sources=int(len(csub)), seconds=walls,
                untuned_default_seconds=seconds_of.get(
                    ("centrality", name, "default")),
                untuned_fused_seconds=None, sweeps=cent.sweeps,
                launches=per_run, equal_to_untuned_default=True,
                betweenness_rtol=BETWEENNESS_RTOL,
                harmonic_rtol=HARMONIC_RTOL)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sharded_run(torch, repro_torch, all_kernels, graphs, lanes_of, srcs,
                untuned, seconds_of, cent_base, mesh):
    """The sharded executor at world size 1 (NCCL, a (1, 1) ``(data,
    model)`` mesh).  Each run pairs one single-device engine call of the
    same pinned form (a fresh handle, its operand built first) with
    ``sharded_apsp`` on operands from ``prepare_sharded`` (the handle's
    dense operand handed over through ``dense_op=``, so no second copy is
    held): rmat16 on 1,024 sources boolean dense (K1), dense with
    ``fused_steps=-1`` (K3), sparse and auto, counting dense (K5),
    tropical dense (K7) and sparse (K9); grid256 on 128 sources boolean
    dense and tropical sparse.  Each is held bit for bit to the
    single-device call (``dist``, ``sweeps``, ``sigma``, and the pinned
    ``direction_counts``) and to the untuned default run of the earlier
    phases, and to scipy on sampled rows; its kernel must launch after
    ``prepare_sharded`` and no index builder may.  The single-device
    calls are comparisons: their launches are taken back out.  Then the
    wired routes on short runs: the facade's ``apsp(mesh=)`` per semiring
    and ``centrality(mesh=)`` on 128 sources, a ``GraphService(mesh=)`` on
    512 queries of stream A's recipe (``sharded_threshold=16``), and a
    512-source job killed after its second chunk and resumed on
    ``mesh_from_plan(plan_remesh(1, model_parallel=1))``.  Yields one
    line of fields per run."""
    import shutil
    import tempfile
    from repro_torch.core.distributed import (ShardedConfig,
                                              prepare_sharded, sharded_apsp)
    from repro_torch.launch.mesh import mesh_from_plan
    from repro_torch.serve import select_top_k
    from repro_torch.train.fault_tolerance import plan_remesh

    index_builders = ("packed_live_words", "nonzero_words", "finite_words",
                      "in_lanes")

    def counts():
        return launch_counts(all_kernels)

    def untake(before):
        """A comparison's launches do not count."""
        for k in all_kernels:
            k.launches = before[k.__name__]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def host_rows(name, semiring, check):
        g = graphs[name]
        if semiring == "tropical":
            return scipy_dijkstra(g, lanes_of[name], check), None
        if semiring == "counting":
            return host_counts(g, check)
        return scipy_dist(g, check), None

    runs = [
        ("rmat16", "boolean", dict(mode="dense"), dict(mode="push"),
         "packed_push_sweep"),
        ("rmat16", "boolean", dict(mode="dense", fused_steps=-1),
         dict(mode="push", fused_steps=-1), "fused_boolean_multisweep"),
        ("rmat16", "boolean", dict(mode="sparse"), dict(mode="sparse"),
         None),
        ("rmat16", "boolean", dict(mode="auto"), None, None),
        ("rmat16", "counting", dict(mode="dense"), dict(mode="push"),
         "fused_counting_sweep"),
        ("rmat16", "tropical", dict(mode="dense"), dict(mode="dense"),
         "fused_minplus_sweep"),
        ("rmat16", "tropical", dict(mode="sparse"), dict(mode="sparse"),
         "sparse_relax_sweep"),
        ("grid256", "boolean", dict(mode="dense"), dict(mode="push"),
         "packed_push_sweep"),
        ("grid256", "tropical", dict(mode="sparse"), dict(mode="sparse"),
         "sparse_relax_sweep"),
    ]
    for name, semiring, opts, single_opts, kernel in runs:
        g, lanes = graphs[name], lanes_of[name]
        sources = srcs[name]
        weights = lanes if semiring == "tropical" else None
        cfg = ShardedConfig(semiring=semiring, **opts)
        dist0, sigma0, sweeps0 = untuned[(semiring, name)]
        single = single_s = None
        dense_op = None
        if single_opts is not None:
            h = repro_torch.prepare(g, weights=weights, **single_opts)
            # operand and index builds are set-up; prepare_sharded takes
            # the handle's over
            if semiring == "tropical":
                if cfg.need_dense:
                    h.prepared_weighted().wdense_index
                    dense_op = h.prepared_weighted()
                else:
                    h.prepared_weighted().relax_index
            elif semiring == "counting":
                h.prepared().adj_index
                dense_op = h.prepared()
            elif cfg.need_dense:
                h.prepared().adj_pull_index
                dense_op = h.prepared()
            before = counts()
            single, single_s = timed(lambda: h.apsp(sources,
                                                    semiring=semiring))
            untake(before)
            del h
        before = counts()
        ops, prepare_s = timed(lambda: prepare_sharded(
            g, mesh, weights=weights, config=cfg, dense_op=dense_op))
        prepare_launches = launched_since(all_kernels, before)
        before = counts()
        res, sharded_s = timed(lambda: sharded_apsp(ops, sources))
        got = launched_since(all_kernels, before)
        if kernel is not None and got.get(kernel, 0) < 1:
            raise AssertionError(f"sharded/{name}/{semiring}/{opts}: "
                                 f"{kernel} never launched")
        if any(got.get(k, 0) for k in index_builders):
            raise AssertionError(f"sharded/{name}/{semiring}/{opts}: an "
                                 f"index was built after prepare_sharded: "
                                 f"{got}")
        dist_h = res.dist.cpu()
        same = torch.equal(dist_h, dist0) and res.sweeps == sweeps0 and (
            sigma0 is None or torch.equal(res.sigma.cpu(), sigma0))
        if single is not None:
            same = same and torch.equal(res.dist, single.dist) and \
                res.sweeps == single.sweeps and (
                    sigma0 is None or torch.equal(res.sigma, single.sigma))
            # one batch of every source here, tiles of 128 there: each
            # ran its pinned form only
            pinned = [res.sweeps, 0] if cfg.mode == "dense" \
                else [0, res.sweeps]
            slot = 0 if cfg.mode == "dense" else \
                len(single.direction_counts) - 1
            counts_ = single.direction_counts.tolist()
            same = same and res.direction_counts.tolist() == pinned and \
                counts_[slot] == sum(counts_)
        if not same:
            raise AssertionError(f"sharded/{name}/{semiring}/{opts}: "
                                 f"differs from the single-device run")
        check = sources[:: len(sources) // N_CHECK][:N_CHECK]
        rows = np.searchsorted(sources, check)
        want, want_sigma = host_rows(name, semiring, check)
        got_rows = dist_h[torch.from_numpy(rows)].numpy()
        ok = np.array_equal(got_rows.astype(want.dtype), want)
        if want_sigma is not None:
            ok = ok and np.array_equal(
                res.sigma.cpu()[torch.from_numpy(rows)].numpy().astype(
                    np.float64), want_sigma)
        if not ok:
            raise AssertionError(f"sharded/{name}/{semiring}/{opts}: rows "
                                 f"differ from the host's")
        yield dict(
            what="run", graph=name, semiring=semiring, options=opts,
            single_options=single_opts, sources=int(len(sources)),
            sharded_seconds=sharded_s, single_seconds=single_s,
            untuned_default_seconds=seconds_of.get(
                (semiring, name, "default")),
            prepare_sharded_seconds=prepare_s,
            prepare_launches=prepare_launches, sweeps=res.sweeps,
            direction_counts=res.direction_counts.tolist(),
            edges_touched=float(res.edges_touched), launches=got,
            single_direction_counts=None if single is None
            else single.direction_counts.tolist(),
            dense_op_handed_over=dense_op is not None,
            equal_to_single=single is not None,
            equal_to_untuned_default=True, rows_checked=int(len(check)))
        del ops, res, single, dense_op, dist_h
        torch.cuda.empty_cache()

    # -- the wired routes -----------------------------------------------
    name, g = "rmat16", graphs["rmat16"]
    sub = srcs[name][:N_CENTRALITY]
    for semiring in ("boolean", "counting", "tropical"):
        h = repro_torch.prepare(
            g, weights=lanes_of[name] if semiring == "tropical" else None)
        before = counts()
        res, wall = timed(lambda: h.apsp(sub, semiring=semiring, mesh=mesh))
        got = launched_since(all_kernels, before)
        dist0, sigma0, _ = untuned[(semiring, name)]
        if not (torch.equal(res.dist.cpu(), dist0[: len(sub)]) and (
                sigma0 is None or torch.equal(res.sigma.cpu(),
                                              sigma0[: len(sub)]))):
            raise AssertionError(f"sharded/facade/{semiring}: differs from "
                                 f"the untuned default rows")
        yield dict(what="facade", graph=name, semiring=semiring,
                   sources=int(len(sub)), seconds=wall, sweeps=res.sweeps,
                   direction_counts=res.direction_counts.tolist(),
                   launches=got, equal_to_untuned_default=True)
        del h, res
        torch.cuda.empty_cache()

    h = repro_torch.prepare(g)
    before = counts()
    cent, wall = timed(lambda: h.centrality(sub, mesh=mesh))
    got = launched_since(all_kernels, before)
    exact = all(np.array_equal(getattr(cent, k), getattr(cent_base, k))
                for k in ("closeness", "eccentricity")) and (
        cent.radius, cent.diameter, cent.sweeps, cent.sigma_checksum) == (
        cent_base.radius, cent_base.diameter, cent_base.sweeps,
        cent_base.sigma_checksum)
    close = np.allclose(cent.betweenness, cent_base.betweenness,
                        rtol=BETWEENNESS_RTOL, atol=0.0) and \
        np.allclose(cent.harmonic, cent_base.harmonic, rtol=HARMONIC_RTOL,
                    atol=0.0)
    if not (exact and close):
        raise AssertionError("sharded/centrality: differs from the "
                             "centrality phase")
    yield dict(what="centrality", graph=name, sources=int(len(sub)),
               seconds=wall, sweeps=cent.sweeps, launches=got,
               single_seconds=seconds_of.get(("centrality", name,
                                              "default")),
               betweenness_rtol=BETWEENNESS_RTOL, harmonic_rtol=HARMONIC_RTOL)
    del h, cent
    torch.cuda.empty_cache()

    # GraphService: stream A's recipe, flushes of >= 16 on the mesh
    clock = VirtualClock()
    h = repro_torch.prepare(g, source_batch=SERVE_BATCH)
    svc = h.serve(max_batch=SERVE_BATCH, n_landmarks=SERVE_LANDMARKS,
                  row_cache_size=SERVE_POOL, completed_retention=None,
                  clock=clock, mesh=mesh,
                  sharded_threshold=SHARDED_THRESHOLD)
    pool, stream, arrivals = serve_stream(g.n_nodes, SHARDED_QUERIES,
                                          SEED + 10, (0.6, 0.2, 0.2))
    acc = {"flush_seconds": 0.0, "flushes": 0}
    svc.oracle
    before = counts()
    t0 = time.perf_counter()
    done = serve_drive(svc, repro_torch.GraphQuery, stream, arrivals, clock,
                       acc)
    wall = time.perf_counter() - t0
    got = launched_since(all_kernels, before)
    serve_check("sharded/serve", done, dict(zip(pool.tolist(),
                                                scipy_dist(g, pool))),
                select_top_k)
    if len(done) != SHARDED_QUERIES or svc.sharded_flushes < 1:
        raise AssertionError(f"sharded/serve: {len(done)} answers, "
                             f"{svc.sharded_flushes} sharded flushes")
    yield dict(what="serve", graph=name, queries=len(done), seconds=wall,
               flushes=acc["flushes"], sharded_flushes=svc.sharded_flushes,
               flush_seconds=acc["flush_seconds"],
               served_by={k: sum(q.served_by == k for q in done)
                          for k in ("cache", "oracle", "sweep", "sharded")},
               launches=got)
    del h, svc, done
    torch.cuda.empty_cache()

    # a job on the mesh, killed after chunk 2, resumed on the plan's mesh
    class Preempt(RuntimeError):
        pass

    def kill(k):
        if k == 1:
            raise Preempt(f"injected preemption after chunk {k}")

    jsrc = srcs[name][:JOB_SOURCES]
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_job_")
    try:
        full_dir, kill_dir = (tempfile.mkdtemp(dir=root) for _ in range(2))
        h = repro_torch.prepare(g, mode="dense")
        kw = dict(semiring="boolean", chunk_size=JOB_CHUNK)
        before = counts()
        full, full_s = timed(lambda: h.apsp(jsrc, mesh=mesh,
                                            checkpoint_dir=full_dir, **kw))
        try:
            h.apsp(jsrc, mesh=mesh, checkpoint_dir=kill_dir, on_chunk=kill,
                   **kw)
            raise AssertionError("sharded/job: the kill did not fire")
        except Preempt:
            pass
        small = mesh_from_plan(plan_remesh(1, model_parallel=1))
        res, resume_s = timed(lambda: h.apsp(jsrc, mesh=small,
                                             checkpoint_dir=kill_dir, **kw))
        got = launched_since(all_kernels, before)
        if got.get("packed_push_sweep", 0) < 1:
            raise AssertionError("sharded/job: K1 never launched")
        same = (res.chunks_restored, res.chunks_computed) == (2, 2) and \
            np.array_equal(res.dist, full.dist) and \
            np.array_equal(res.dist, untuned[("boolean", name)][0]
                           [: len(jsrc)].numpy()) and \
            (res.sweeps, res.edges_touched) == (full.sweeps,
                                                full.edges_touched) and \
            np.array_equal(res.direction_counts, full.direction_counts)
        if not same:
            raise AssertionError("sharded/job: the resumed run differs")
        yield dict(what="job", graph=name, workload="boolean",
                   sources=int(len(jsrc)), chunk_size=JOB_CHUNK,
                   full_seconds=full_s, resumed_seconds=resume_s,
                   resumed_mesh=list(small.mesh.shape),
                   chunks_restored=res.chunks_restored,
                   chunks_computed=res.chunks_computed, sweeps=res.sweeps,
                   direction_counts=res.direction_counts.tolist(),
                   launches=got)
        del h, full, res
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def sharded_block_check(torch, g, lanes, sources):
    """The calls that ranks with C = 2 make, in one process: rmat16's
    operands split into two K-row blocks (``prepare_sharded``'s builder)
    and its lanes by ``edge_partition_global``, at n_pad = a multiple of
    256, on the state after 2 sweeps (made by the full operand's kernel
    from the sources).  K1, K5, K7 and K9 run on each block as a rank
    runs them: all its source rows in 128-row tiles, with the block's
    live-word index (K9: the part's in-lane index).  Each is held bit for
    bit to its plain version, and the blocks' ⊕ (OR of the new bits, SUM
    of the gated counting partials, MIN) to the full operand's call.
    Returns one line of fields per kernel."""
    from repro_torch.core import distributed as D
    from repro_torch.core.frontier import pack_bits
    from repro_torch.graph.partition import edge_partition_global
    from repro_torch.kernels import bovm, counting, tropical
    from repro_torch.kernels import registry
    from repro_torch.kernels.bovm import ref as R
    from repro_torch.kernels.counting import ref as CR
    from repro_torch.kernels.tropical import ref as TR

    C = 2
    n, n_pad = g.n_nodes, g.n_padded(128 * C)
    nk = n_pad // C
    s = len(sources)
    step = 3                                  # the sweep after 2 sweeps
    src = torch.from_numpy(sources.astype(np.int64)).cuda()
    rows = torch.arange(s, device="cuda")
    f0 = torch.zeros((s, n_pad), dtype=torch.int8, device="cuda")
    f0[rows, src] = 1
    col_ok = torch.arange(n_pad, device="cuda")[None, :] < n
    wl = torch.from_numpy(lanes).cuda()
    lines = []

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def block(semiring, c, packed=False):
        """Rank c's block and its live-word index, as prepare_sharded
        builds them."""
        blk = D._dense_block(g, n_pad, c * nk, nk, semiring,
                             wl if semiring == "tropical" else None, packed)
        return blk, registry.get(semiring).operand_index(blk)

    def line(name, per_block, combined):
        if not (all(per_block) and combined):
            raise AssertionError(f"sharded_blocks/{name}: a block differs "
                                 f"from its plain version or the blocks' "
                                 f"combine from the full operand's call")
        lines.append(dict(kernel=name, blocks=C, n_pad=n_pad, rows=s,
                          row_tiles=-(-s // bs), step=step,
                          blocks_equal_plain=True,
                          combine_equal_full=True))

    # K1: OR of the blocks' new bits
    full = D._dense_block(g, n_pad, 0, n_pad, "boolean", None, True)
    wk, bs = 4, min(s, 128)
    d = torch.where(f0 != 0, 0, -1).to(torch.int32)
    d = torch.where(col_ok, d, 0).to(torch.int32)
    f = f0
    for t in (1, 2):
        f, d = bovm.packed_push_sweep(pack_bits(f != 0), full, d, t,
                                      bs=bs, wk=wk)
    new_full, d_full = bovm.packed_push_sweep(pack_bits(f != 0), full, d,
                                              step, bs=bs, wk=wk)
    del full
    acc, ok = torch.zeros_like(new_full), []
    for c in range(C):
        blk, idx = block("boolean", c, True)
        fp = pack_bits(f[:, c * nk: (c + 1) * nk] != 0)
        out = bovm.packed_push_sweep(fp, blk, d, step, bs=bs, wk=wk,
                                     index=idx)
        ok.append(same(out, R.packed_push_ref(fp, blk, d, step)))
        acc |= out[0]
        del blk, idx
    line("packed_push_sweep", ok, torch.equal(acc, new_full) and
         torch.equal(torch.where(acc != 0, step, d), d_full))

    # K5: SUM of the gated partials
    full = D._dense_block(g, n_pad, 0, n_pad, "counting", None, False)
    d = torch.where(f0 != 0, 0, -1).to(torch.int32)
    d = torch.where(col_ok, d, 0).to(torch.int32)
    sg = (f0 != 0).to(torch.float32)
    f = f0
    for t in (1, 2):
        f, d, sg = counting.fused_counting_sweep(
            torch.where(f != 0, sg, 0.0), full, d, sg, t, bs=bs)
    fs = torch.where(f != 0, sg, 0.0)
    new_full, d_full, sg_full = counting.fused_counting_sweep(
        fs, full, d, sg, step, bs=bs)
    del full
    cand, ok = torch.zeros_like(sg), []
    for c in range(C):
        blk, idx = block("counting", c)
        fs_k = fs[:, c * nk: (c + 1) * nk].contiguous()
        out = counting.fused_counting_sweep(fs_k, blk, d, sg, step, bs=bs,
                                            index=idx)
        ok.append(same(out, CR.counting_sweep_ref(fs_k, blk, d, sg, step)))
        cand += torch.where(out[0] != 0, out[2], 0.0)
        del blk, idx
    new = (cand > 0) & (d == -1)
    line("fused_counting_sweep", ok, torch.equal(new.to(torch.int8), new_full)
         and torch.equal(torch.where(new, step, d), d_full)
         and torch.equal(torch.where(new, cand, sg), sg_full))

    # K7 and K9: MIN of the blocks' and of the parts' distances
    inf = float("inf")
    d = torch.where(f0 != 0, 0.0, inf).to(torch.float32)
    f = f0
    idx = tropical.in_lanes(g.src, g.dst, wl, n_pad)
    for _ in (1, 2):
        f, d = tropical.sparse_relax_sweep(f, d, g.src, g.dst, wl,
                                           index=idx)
    w_min = wl.min()
    fd = torch.where(f != 0, d, inf)
    full = D._dense_block(g, n_pad, 0, n_pad, "tropical", wl, False)
    new_full, d_full = tropical.fused_minplus_sweep(fd, full, d, w_min,
                                                    bs=bs)
    del full
    torch.cuda.empty_cache()
    nd, ok = torch.full_like(d, inf), []
    for c in range(C):
        blk, bidx = block("tropical", c)
        fd_k = fd[:, c * nk: (c + 1) * nk].contiguous()
        out = tropical.fused_minplus_sweep(fd_k, blk, d, w_min, bs=bs,
                                           index=bidx)
        ok.append(same(out, TR.minplus_sweep_ref(fd_k, blk, d)))
        nd = torch.minimum(nd, out[1])
        del blk, bidx
        torch.cuda.empty_cache()
    line("fused_minplus_sweep", ok, torch.equal(nd, d_full) and
         torch.equal((nd < d).to(torch.int8), new_full))
    new_full, d_full = tropical.sparse_relax_sweep(f, d, g.src, g.dst, wl,
                                                   index=idx)
    parts = edge_partition_global(g, C, weights=wl)
    nd, ok = torch.full_like(d, inf), []
    for c in range(C):
        ps, pd, pw = (parts[k][c].contiguous() for k in ("src", "dst", "w"))
        out = tropical.sparse_relax_sweep(
            f, d, ps, pd, pw, index=tropical.in_lanes(ps, pd, pw, n_pad))
        ok.append(same(out, TR.sparse_relax_ref(f, d, ps, pd, pw)))
        nd = torch.minimum(nd, out[1])
    line("sparse_relax_sweep", ok, torch.equal(nd, d_full) and
         torch.equal((nd < d).to(torch.int8), new_full))
    return lines

def io_run(torch, repro_torch, all_kernels, g, lanes, sources, want_bool,
           want_trop):
    """A graph file on disk -> the port's loaders -> ``prepare`` ->
    ``apsp``, at rmat16's full width.  rmat16 is written with
    ``save_mtx``, as a ``symmetric`` pattern file (its ``src < dst``
    entries, written here with numpy), as a 1-indexed edge list, and with
    the lane weights through ``save_mtx(weights=)`` and
    ``save_edgelist(weights=)``; each file is read back onto the card and
    held equal to the in-memory graph (the six CSR arrays; the lane
    weights of the real edges bit for bit, +inf on the padded lanes).
    The general file's graph runs the boolean default, pinned push (K1),
    pinned pull (K2) and ``fused_steps=-1`` (K3); the weighted file's the
    tropical default (K9) and pinned dense (K7), the weighted edge list's
    the tropical default: every ``dist`` equal to the in-memory graph's
    default run (``want_bool`` / ``want_trop``, host copies; its pinned
    and fused runs equal it, checked above).  Returns one line of fields
    per file and per run."""
    import shutil
    import tempfile
    from repro_torch.graph import io as gio

    root = tempfile.mkdtemp(prefix="chip_smoke_io_")
    lines = []
    try:
        paths = {k: str(Path(root) / k) for k in (
            "general.mtx", "symmetric.mtx", "edges_1idx.txt",
            "weighted.mtx", "weighted.txt")}
        src, dst = g.edge_arrays_np()
        lanes_t = torch.from_numpy(lanes)
        upper = src < dst
        # an edge list has no node count: it holds the nodes up to the
        # largest id with an edge, so rmat16's isolated tail drops off
        n_list = int(max(src.max(), dst.max())) + 1

        def n_of(name):
            return n_list if name.endswith(".txt") else g.n_nodes

        def write_symmetric(path):
            with open(path, "w") as f:
                f.write("%%MatrixMarket matrix coordinate pattern "
                        "symmetric\n")
                f.write(f"{g.n_nodes} {g.n_nodes} {int(upper.sum())}\n")
                np.savetxt(f, np.stack([dst[upper] + 1, src[upper] + 1],
                                       axis=1), fmt="%d")

        writers = {
            "general.mtx": lambda p: gio.save_mtx(g, p),
            "symmetric.mtx": write_symmetric,
            "edges_1idx.txt": lambda p: np.savetxt(
                p, np.stack([src + 1, dst + 1], axis=1), fmt="%d"),
            "weighted.mtx": lambda p: gio.save_mtx(g, p, weights=lanes_t),
            "weighted.txt": lambda p: gio.save_edgelist(g, p,
                                                        weights=lanes),
        }
        readers = {
            "general.mtx": lambda p: (gio.load_mtx(p), None),
            "symmetric.mtx": lambda p: (gio.load_mtx(p), None),
            "edges_1idx.txt": lambda p: (gio.load_edgelist(
                p, zero_indexed=False), None),
            "weighted.mtx": lambda p: gio.load_mtx(p, return_weights=True),
            "weighted.txt": lambda p: gio.load_edgelist(p, weighted=True),
        }
        loaded = {}
        for name, path in paths.items():
            t0 = time.perf_counter()
            writers[name](path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            lg, lw = readers[name](path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            if lg.device.type != "cuda" or (lw is not None and
                                            lw.device.type != "cuda"):
                raise AssertionError(f"io/{name}: the loader's default "
                                     f"device is not the card")
            n = n_of(name)
            if (lg.n_nodes, lg.n_edges, lg.m_pad) != (n, g.n_edges, g.m_pad):
                raise AssertionError(f"io/{name}: sizes differ from the "
                                     f"in-memory graph")
            m = g.n_edges
            for k in g.ARRAYS:
                a, b = getattr(lg, k), getattr(g, k)
                same = torch.equal(a, b[: n + 1]) if k.startswith("indptr") \
                    else torch.equal(a[:m], b[:m]) and bool((a[m:] == n).all())
                if not same:
                    raise AssertionError(f"io/{name}: {k} differs from the "
                                         f"in-memory graph")
            if lw is not None:
                got = lw.cpu().numpy()
                if not (np.array_equal(got[: g.n_edges].view(np.int32),
                                       lanes[: g.n_edges].view(np.int32))
                        and np.isinf(got[g.n_edges:]).all()):
                    raise AssertionError(f"io/{name}: lane weights differ "
                                         f"from the in-memory lanes")
            loaded[name] = (lg, lw)
            lines.append(dict(file=name, bytes=Path(path).stat().st_size,
                              entries=int(upper.sum()) if "symmetric" in name
                              else g.n_edges, n_nodes=n,
                              isolated_tail_dropped=g.n_nodes - n,
                              save_seconds=save_s, load_seconds=load_s,
                              arrays_equal=True,
                              lanes_equal=lw is not None))
        runs = [("general.mtx", "boolean", "default", {}),
                ("general.mtx", "boolean", "push",
                 dict(mode="push", use_kernel=True)),
                ("general.mtx", "boolean", "pull",
                 dict(mode="pull", use_kernel=True)),
                ("general.mtx", "boolean", "fused", dict(fused_steps=-1)),
                ("weighted.mtx", "tropical", "default", {}),
                ("weighted.mtx", "tropical", "dense",
                 dict(mode="dense", use_kernel=True)),
                ("weighted.txt", "tropical", "default", {})]
        for name, semiring, run, opts in runs:
            lg, lw = loaded[name]
            h = repro_torch.prepare(lg, weights=lw, **opts)
            if semiring == "boolean":            # operand builds = set-up
                h.prepared().adj_pull
                if run != "fused":
                    h.prepared().adj_pull_index
            else:                                # as the weighted phase
                pw = h.prepared_weighted()
                pw.wdense
                pw.wdense_index
                if run == "default":
                    pw.relax_index
            n = n_of(name)
            keep = sources < n                 # the sources the file holds
            before = launch_counts(all_kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = h.apsp(sources[keep], semiring=semiring)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = want_bool if semiring == "boolean" else want_trop
            rows = torch.from_numpy(np.flatnonzero(keep))
            if not torch.equal(res.dist.cpu(), want[0][rows, :n]) or (
                    n == g.n_nodes and res.sweeps != want[2]):
                raise AssertionError(f"io/{name}/{semiring}/{run}: dist or "
                                     f"sweeps differ from the in-memory "
                                     f"graph's run")
            lines.append(dict(file=name, semiring=semiring, run=run,
                              options=opts, sources=int(keep.sum()),
                              apsp_seconds=wall, sweeps=res.sweeps,
                              direction_counts=res.direction_counts.tolist(),
                              dist_equal_in_memory=True,
                              launches=launched_since(all_kernels, before)))
            del h, res
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return lines


def suite_run(torch, repro_torch, all_kernels):
    """Every graph of ``configs.dawn.GRAPH_SUITE`` (the paper's experiment
    families) on the card: ``prepare(g).apsp`` over ``min(SOURCE_SET_SIZE,
    n)`` seeded sources, default options, every row equal to scipy's BFS.
    One line per graph."""
    from repro_torch.configs import dawn
    rng = np.random.default_rng(SEED)
    lines = []
    for name in sorted(dawn.GRAPH_SUITE):
        t0 = time.perf_counter()
        g = dawn.GRAPH_SUITE[name]()
        build_s = time.perf_counter() - t0
        if g.device.type != "cuda":
            raise AssertionError(f"suite/{name}: not on the card")
        k = min(dawn.SOURCE_SET_SIZE, g.n_nodes)
        srcs = np.sort(rng.choice(g.n_nodes, k, replace=False)) \
            .astype(np.int32)
        h = repro_torch.prepare(g)
        h.prepared()
        before = launch_counts(all_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = h.apsp(srcs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not np.array_equal(res.dist.cpu().numpy(), scipy_dist(g, srcs)):
            raise AssertionError(f"suite/{name}: dist differs from scipy "
                                 f"BFS")
        lines.append(dict(graph=name, n_nodes=g.n_nodes, n_edges=g.n_edges,
                          sources=k, build_seconds=build_s, seconds=wall,
                          sweeps=res.sweeps,
                          direction_counts=res.direction_counts.tolist(),
                          rows_checked=k,
                          launches=launched_since(all_kernels, before)))
        del h, res, g
    torch.cuda.empty_cache()
    return lines


def sample_run(torch, g, seeds):
    """GraphSAGE's fanout sample on rmat16 on the card: ``sample_subgraph``
    from 1,024 seeds with fanouts (25, 10) and a CUDA generator, every id
    of hop h+1 an out-neighbour of its parent (or the parent itself at
    degree 0), held on the host against the CSR; then ``sampled_batch``'s
    shapes.  One line of fields."""
    from repro_torch.data.graphs import sampled_batch
    from repro_torch.graph.sampler import sample_subgraph
    gen_ = torch.Generator(device="cuda")
    gen_.manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layers = sample_subgraph(g, seeds, gen_, SAMPLE_FANOUTS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sizes = [len(seeds)]
    for f in SAMPLE_FANOUTS:
        sizes.append(sizes[-1] * f)
    if [int(l.shape[0]) for l in layers] != sizes or \
            any(l.device.type != "cuda" for l in layers):
        raise AssertionError("sample: layer sizes or devices are wrong")
    src, dst = g.edge_arrays_np()
    keys = src.astype(np.int64) * g.n_nodes + dst       # sorted: the CSR
    deg = g.out_degrees().cpu().numpy()
    host = [l.cpu().numpy().astype(np.int64) for l in layers]
    for h, f in enumerate(SAMPLE_FANOUTS):
        par = np.repeat(host[h], f)
        kid = host[h + 1]
        pos = np.minimum(np.searchsorted(keys, par * g.n_nodes + kid),
                         len(keys) - 1)
        ok = np.where(deg[par] > 0, keys[pos] == par * g.n_nodes + kid,
                      kid == par)
        if not ok.all():
            raise AssertionError(f"sample: {int((~ok).sum())} ids of hop "
                                 f"{h + 1} are not neighbours of their "
                                 f"parents")
    t0 = time.perf_counter()
    batch = sampled_batch(g, seeds, SAMPLE_FANOUTS, d_feat=SAMPLE_FEAT,
                          seed=SEED)
    batch_s = time.perf_counter() - t0
    n_sub, n_e = sum(sizes), sum(sizes[1:])
    want = {"feat": (n_sub, SAMPLE_FEAT), "src": (n_e,), "dst": (n_e,),
            "labels": (n_sub,), "targets": (n_sub, 2), "node_mask": (n_sub,),
            "pos": (n_sub, 3), "species": (n_sub,), "graph_id": (n_sub,),
            "energy": (1,)}
    if {k: v.shape for k, v in batch.items()} != want:
        raise AssertionError("sample: sampled_batch shapes are wrong")
    return dict(seeds=int(len(seeds)), fanouts=list(SAMPLE_FANOUTS),
                layer_sizes=sizes, seconds=wall,
                zero_degree_parents=int((deg[host[0]] == 0).sum()),
                neighbours_checked=int(sum(sizes[1:])),
                batch_seconds=batch_s, batch_nodes=n_sub, d_feat=SAMPLE_FEAT)


def train_run(torch, smi):
    """The training substrate on the card: a bigram model with a stacked
    (L, d, d) residual leaf over ``lm_iterator`` batches, through
    ``make_train_step`` and ``train``: AdamW, Adafactor and SGD each make
    the loss fall; ``accum=4`` equals ``accum=1`` (SGD: the parameter
    change is the gradient) within rtol 1e-5 / atol 1e-6; a
    ``CheckpointHook`` run restored and resumed equals the unbroken run
    bit for bit; ``compress_int8`` / ``compress_topk`` on the card equal
    the CPU bit for bit; then ``shard_batch``, ``make_jitted_step`` and
    ``make_cross_pod_psum`` on a world-size-1 NCCL mesh ``(pod, data,
    model)``.  Yields lines of fields."""
    import datetime
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.data.tokens import lm_iterator
    from repro_torch.launch.mesh import PartitionSpec as P, make_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import compression as C
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_loop import (make_jitted_step,
                                              make_train_step, train)
    v, d, n_l = TRAIN_VOCAB, TRAIN_D, TRAIN_LAYERS

    def params0():
        rng = np.random.default_rng(SEED)
        p = {"emb": rng.normal(size=(v, d)) * 0.5,
             "stack": rng.normal(size=(n_l, d, d)) / np.sqrt(d),
             "out": rng.normal(size=(d, v)) * 0.5, "bias": np.zeros(v)}
        return {k: torch.from_numpy(x.astype(np.float32)).cuda()
                for k, x in p.items()}

    def loss_fn(params, batch):
        # one-hot products, not an embedding gather: a gather's backward
        # adds with atomics on the card, in no fixed order, and the resume
        # check asks for the same bits twice
        onehot = lambda t: torch.nn.functional.one_hot(
            t.long(), v).to(torch.float32)
        h = onehot(batch["tokens"]) @ params["emb"]
        for i in range(params["stack"].shape[0]):
            h = torch.tanh(h @ params["stack"][i]) + h
        logp = torch.log_softmax(h @ params["out"] + params["bias"], dim=-1)
        return -(onehot(batch["labels"]) * logp).sum(-1).mean()

    def data(start=0):
        return lm_iterator(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                           vocab=v, seed=SEED, start_step=start)

    opts = {"adamw": O.adamw(peak_lr=1e-2, schedule=O.cosine_schedule(
                1e-2, warmup=2, total=2 * TRAIN_STEPS)),
            "adafactor": O.adafactor(peak_lr=3e-2, schedule=O.cosine_schedule(
                3e-2, warmup=2, total=2 * TRAIN_STEPS)),
            "sgd": O.sgd(1.0)}
    for name, opt in opts.items():
        losses = []
        p = params0()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, _ = train(p, opt.init(p), make_train_step(loss_fn, opt),
                        data(), n_steps=TRAIN_STEPS,
                        hooks=[lambda i, p_, s_, m: losses.append(
                            float(m["loss"]))])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not (np.mean(losses[-3:]) < losses[0] and
                all(np.isfinite(losses))):
            raise AssertionError(f"train/{name}: the loss did not fall "
                                 f"({losses[0]} -> {losses[-3:]})")
        if any(x.device.type != "cuda" for x in p.values()):
            raise AssertionError(f"train/{name}: params left the card")
        yield dict(check="loss_falls", optimizer=name, steps=TRAIN_STEPS,
                   first_loss=losses[0], last_loss=losses[-1],
                   seconds=wall, nvidia_smi=smi)

    # accum=4 against accum=1: one SGD step, the same batch
    opt = O.sgd(0.1)
    p = params0()
    batch = next(data())
    p1, _, m1 = make_train_step(loss_fn, opt)(p, opt.init(p), batch)
    p4, _, m4 = make_train_step(loss_fn, opt, accum=4)(p, opt.init(p), batch)
    err = max(float(((p4[k] - p1[k]).abs() - TRAIN_ATOL
                     - TRAIN_RTOL * p1[k].abs()).max()) for k in p)
    if err > 0 or not torch.allclose(m4["loss"], m1["loss"],
                                     rtol=TRAIN_RTOL, atol=0):
        raise AssertionError(f"train: accum=4 differs from accum=1 beyond "
                             f"rtol {TRAIN_RTOL} / atol {TRAIN_ATOL}")
    yield dict(check="accum", accum=4, rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
               loss_1=float(m1["loss"]), loss_4=float(m4["loss"]),
               max_abs_diff=max(float((p4[k] - p1[k]).abs().max())
                                for k in p))

    # checkpoint, restore, resume: the unbroken run's bits
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        opt = opts["adamw"]
        step = make_train_step(loss_fn, opt)
        p = params0()
        s = opt.init(p)
        hook = ckpt.CheckpointHook(root, interval=TRAIN_STEPS // 2)
        pa, sa, _ = train(p, s, step, data(), n_steps=TRAIN_STEPS,
                          hooks=[hook])
        hook.flush()
        t0 = time.perf_counter()
        tree, at = ckpt.restore(root, ckpt.latest_step(root),
                                {"params": p, "opt": s}, device="cuda")
        restore_s = time.perf_counter() - t0
        pb, sb, _ = train(tree["params"], tree["opt"], step, data(at),
                          n_steps=at + TRAIN_STEPS // 2, start_step=at)
        pc, sc, _ = train(pa, sa, step, data(at),
                          n_steps=at + TRAIN_STEPS // 2, start_step=at)
        same = all(torch.equal(pb[k], pc[k]) for k in pc) and all(
            torch.equal(sb[f][k], sc[f][k]) for f in ("m", "v") for k in pc)
        if at != TRAIN_STEPS or not same or not torch.equal(sb["step"],
                                                             sc["step"]):
            raise AssertionError("train: the resumed run differs from the "
                                 "unbroken run")
        yield dict(check="resume", restored_step=at,
                   checkpoints=hook.written, restore_seconds=restore_s,
                   bit_identical=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # compression on the card against the CPU, with error feedback
    grads = {k: torch.randn(x.shape, generator=torch.Generator(
        device="cuda").manual_seed(i), device="cuda")
        for i, (k, x) in enumerate(params0().items())}
    for method in ("int8", "topk"):
        ef_c = C.init_error_feedback(grads)
        ef_h = C.init_error_feedback({k: x.cpu() for k, x in grads.items()})
        for _ in range(3):
            if method == "int8":
                (gc, ef_c), (gh, ef_h) = (C.compress_int8(grads, ef_c),
                                          C.compress_int8(
                    {k: x.cpu() for k, x in grads.items()}, ef_h))
            else:
                (gc, ef_c), (gh, ef_h) = (C.compress_topk(grads, ef_c, 0.05),
                                          C.compress_topk(
                    {k: x.cpu() for k, x in grads.items()}, ef_h, 0.05))
            for k in grads:
                if not (torch.equal(gc[k].cpu(), gh[k]) and
                        torch.equal(ef_c[k].cpu(), ef_h[k])):
                    raise AssertionError(f"train: {method} compression of "
                                         f"{k} differs from the CPU")
        raw, wire = C.compressed_bytes(grads, method, 0.05)
        yield dict(check="compression", method=method, rounds=3,
                   bit_identical_cpu=True, raw_bytes=raw, wire_bytes=wire)

    # the mesh: NCCL at world size 1, a (1, 1, 1) (pod, data, model) mesh
    nccl_dir = tempfile.mkdtemp(prefix="chip_smoke_train_nccl_")
    dist.init_process_group(
        "nccl", init_method=f"file://{nccl_dir}/store", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        batch = next(data())
        specs = {"tokens": P("data"), "labels": P(("data", "model"))}
        t0 = time.perf_counter()
        placed = shard_batch(mesh, batch, specs)
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        for k, x in placed.items():
            if x.to_local().device.type != "cuda" or not np.array_equal(
                    x.full_tensor().cpu().numpy(), batch[k]):
                raise AssertionError(f"train: shard_batch placed {k} wrong")
        opt = opts["adamw"]
        param_specs = {"emb": P("data", None), "stack": P(None, "data",
                                                          "model"),
                       "out": P(None, "model"), "bias": P()}
        jstep, _ = make_jitted_step(loss_fn, opt, mesh, param_specs,
                                    batch_specs=specs)
        step = make_train_step(loss_fn, opt)
        pj = pp = params0()
        sj = sp = opt.init(pp)
        for i, b in zip(range(2), data()):
            pj, sj, _ = jstep(pj, sj, shard_batch(mesh, b, specs))
            pp, sp, _ = step(pp, sp, b)
        if not all(torch.equal(pj[k].full_tensor(), pp[k]) for k in pp):
            raise AssertionError("train: make_jitted_step differs from the "
                                 "step on one device")
        g = grads["out"]
        t0 = time.perf_counter()
        got = C.make_cross_pod_psum("int8", mesh=mesh)(g)
        torch.cuda.synchronize()
        psum_s = time.perf_counter() - t0
        h = g.cpu().numpy()
        scale = np.maximum(np.abs(h).max() / np.float32(127.0),
                           np.float32(1e-12))
        want = np.clip(np.round(h / scale), -127, 127).astype(np.int8) \
            .astype(np.int32).astype(np.float32) * scale
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError("train: the cross-pod sum differs from "
                                 "the shared-scale int32 formula")
        yield dict(check="mesh", mesh=[1, 1, 1], shard_batch_seconds=shard_s,
                   jitted_steps=2, jitted_equal=True,
                   cross_pod_psum_seconds=psum_s, psum_equal=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(nccl_dir, ignore_errors=True)


def examples_run(torch, all_kernels):
    """Each of ``EXAMPLES``: the script's ``main(argv)`` called in this
    process on the card, its printed lines captured; a failed assert in
    an example raises here.  The mesh examples run at world size 1 in one
    NCCL group made here, which their ``make_mesh`` reuses."""
    import contextlib
    import datetime
    import importlib.util
    import io
    import shutil
    import tempfile
    import torch.distributed as dist
    folder = ROOT / "examples"
    sys.path.insert(0, str(folder))
    nccl_dir = None
    try:
        for name, argv in EXAMPLES:
            if name in MESH_EXAMPLES and nccl_dir is None:
                nccl_dir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
                dist.init_process_group(
                    "nccl", init_method=f"file://{nccl_dir}/store", rank=0,
                    world_size=1, timeout=datetime.timedelta(seconds=300))
            spec = importlib.util.spec_from_file_location(
                name, folder / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            before = launch_counts(all_kernels)
            out = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mod.main(list(argv))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            printed = out.getvalue().splitlines()
            yield dict(example=name, argv=list(argv), seconds=wall,
                       launches=launched_since(all_kernels, before),
                       last_line=printed[-1], printed=printed)
            torch.cuda.empty_cache()
    finally:
        if nccl_dir is not None:
            dist.destroy_process_group()
            shutil.rmtree(nccl_dir, ignore_errors=True)
        sys.path.remove(str(folder))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch
    from repro_torch.core.centrality import (CentralityConfig,
                                             counting_apsp_blocks)
    from repro_torch.core.engine import EngineConfig, apsp_engine_blocks
    from repro_torch.core.frontier import pack_bits
    from repro_torch.graph import generators as gen
    from repro_torch.kernels import _build
    from repro_torch.kernels import bovm, counting, tropical
    from repro_torch.kernels.bovm import ref as R
    from repro_torch.kernels.counting import ref as CR
    from repro_torch.kernels.tropical import ref as TR

    # the plain versions and the library yardstick take full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = (bovm.packed_push_sweep, bovm.packed_pull_sweep,
               bovm.fused_boolean_multisweep, bovm.fused_sweep,
               bovm.packed_live_words, bovm.pack_frontier)
    ckernels = (counting.fused_counting_sweep,
                counting.fused_counting_multisweep, counting.nonzero_words)
    wkernels = (tropical.fused_minplus_sweep,
                tropical.fused_minplus_multisweep,
                tropical.sparse_relax_sweep, tropical.finite_words,
                tropical.in_lanes)
    sources_of = {k.__name__: str(Path(sys.modules[k.__module__].SOURCE)
                                  .relative_to(ROOT))
                  for k in kernels + ckernels + wkernels}

    smi = nvidia_smi()
    emit(phase="device", nvidia_smi=smi,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- build: one nvcc per source, all started together ------------------
    sources_cu = sorted((SRC / "repro_torch").rglob("csrc/*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources_cu)) as pool:
        built = list(pool.map(_build.build, sources_cu))
    emit(phase="build", seconds=time.perf_counter() - t0,
         sources=[str(s.relative_to(ROOT)) for s in sources_cu],
         libraries=[p.name for p in built])

    # -- the frontier packer at the cells' shapes, on the empty card -------
    packs = pack_rows(torch, bovm, pack_bits,
                      sources_of["pack_frontier"])
    for row in packs:
        emit(phase="pack", **row)

    # -- graphs --------------------------------------------------------------
    t0 = time.perf_counter()
    graphs = {
        "rmat16": gen.rmat(16, 16, directed=False, seed=SEED,
                           device="cuda"),
        "grid256": gen.grid2d(256, 256, device="cuda"),
    }
    expect_edges = {"rmat16": 1_820_400, "grid256": 261_120}
    rng = np.random.default_rng(SEED)
    batch = {"rmat16": 1024, "grid256": 128}
    srcs = {name: np.sort(rng.choice(g.n_nodes, batch[name], replace=False))
            .astype(np.int32) for name, g in graphs.items()}
    for name, g in graphs.items():
        if g.n_edges != expect_edges[name]:
            raise AssertionError(f"{name}: {g.n_edges} edges, expected "
                                 f"{expect_edges[name]}")
    emit(phase="graphs", seconds=time.perf_counter() - t0,
         graphs={k: {"n_nodes": g.n_nodes, "n_edges": g.n_edges,
                     "n_pad": g.n_padded(), "sources": int(len(srcs[k]))}
                 for k, g in graphs.items()})

    # -- the main path: default, pinned push / pull, fused -------------------
    runs = {
        "default": {},
        "push": dict(mode="push", use_kernel=True),
        "pull": dict(mode="pull", use_kernel=True),
        "fused": dict(fused_steps=-1),
    }
    bovm.reset_launches()
    by_graph = {}                 # kernel -> graph -> main-path launches
    results = {}
    # the untuned default runs (host dist, sigma, sweeps) and the default
    # and fused seconds, which the tune phase holds its tuned runs to
    untuned, seconds_of = {}, {}
    for name, g in graphs.items():
        check = srcs[name][:: len(srcs[name]) // N_CHECK][:N_CHECK]
        want = scipy_dist(g, check)
        rows = np.searchsorted(srcs[name], check)
        for run, opts in runs.items():
            h = repro_torch.prepare(g, **opts)
            h.prepared().adj_pull                # operand build = set-up
            if run != "fused":                   # K1 / K2's index, too
                h.prepared().adj_pull_index
            before = [k.launches for k in kernels]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = h.apsp(srcs[name])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = res.dist[torch.from_numpy(rows).cuda()].cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{name}/{run}: dist differs from "
                                     f"scipy BFS")
            if not torch.isfinite(res.edges_touched):
                raise AssertionError(f"{name}/{run}: edges_touched")
            results[(name, run)] = res
            seconds_of[("boolean", name, run)] = wall
            if run == "default":
                untuned[("boolean", name)] = (res.dist.cpu(), None,
                                              res.sweeps)
            deg = h.prepared().deg[: g.n_nodes].double()
            touched64 = float(((res.dist >= 0).double() * deg).sum())
            touched = float(res.edges_touched)
            if run != "fused" and abs(touched - touched64) > \
                    EDGES_RTOL * touched64:
                raise AssertionError(f"{name}/{run}: edges_touched "
                                     f"{touched} vs {touched64}")
            emit(phase="apsp", graph=name, run=run, options=opts,
                 seconds=wall, sweeps=res.sweeps,
                 direction_counts=res.direction_counts.tolist(),
                 edges_touched=touched, edges_touched_f64=touched64,
                 launches=tally(by_graph, name, kernels, before),
                 dist_checked_rows=int(len(check)))
        base = results[(name, "default")]
        for run in ("push", "pull", "fused"):
            if not torch.equal(results[(name, run)].dist, base.dist):
                raise AssertionError(f"{name}/{run}: dist differs from "
                                     f"the default run")
        per, fused = results[(name, "push")], results[(name, "fused")]
        if per.sweeps != fused.sweeps or not torch.equal(
                per.direction_counts, fused.direction_counts):
            raise AssertionError(f"{name}: fused accounting differs from "
                                 f"the per-sweep push")
    launches = {k.__name__: k.launches for k in kernels}
    emit(phase="main_path", launches=launches)
    for k in kernels[:3] + kernels[4:]:
        if launches[k.__name__] < 1:
            raise AssertionError(f"{k.__name__} never launched on the "
                                 f"main path")
    del results

    # -- the counting path on rmat16: default, pinned push, fused ------------
    # grid256 takes no counting run: its path counts overflow float32
    gdist, gsigma = host_counts(graphs["grid256"],
                                srcs["grid256"][:N_CHECK])
    emit(phase="grid256_counts", sources=N_CHECK,
         max_sigma_f64=float(gsigma.max()), depth=int(gdist.max()),
         float32_max=float(np.finfo(np.float32).max))
    g = graphs["rmat16"]
    csrcs = srcs["rmat16"]
    check = csrcs[:: len(csrcs) // N_CHECK][:N_CHECK]
    rows = torch.from_numpy(np.searchsorted(csrcs, check)).cuda()
    want_dist, want_sigma = host_counts(g, check)
    if not np.array_equal(want_dist, scipy_dist(g, check)):
        raise AssertionError("host counting BFS differs from scipy BFS")
    cruns = {
        "default": {},
        "push": dict(mode="push", use_kernel=True),
        "fused": dict(fused_steps=-1),
    }
    counting.reset_launches()
    cres = {}
    for run, opts in cruns.items():
        h = repro_torch.prepare(g, **opts)
        h.prepared().adj                     # operand build = set-up
        h.prepared().adj_index               # K5 / K6's live-word index, too
        before = [k.launches for k in ckernels]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = h.apsp(csrcs, semiring="counting")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        max_sigma = float(res.sigma.max())
        if not max_sigma < EXACT_F32:
            raise AssertionError(f"counting/{run}: a path count reached "
                                 f"{max_sigma}, not exact in float32")
        if not np.array_equal(res.dist[rows].cpu().numpy(), want_dist):
            raise AssertionError(f"counting/{run}: dist differs from scipy "
                                 f"BFS")
        if not np.array_equal(res.sigma[rows].cpu().numpy()
                              .astype(np.float64), want_sigma):
            raise AssertionError(f"counting/{run}: sigma differs from the "
                                 f"float64 host count")
        cres[run] = res
        seconds_of[("counting", "rmat16", run)] = wall
        if run == "default":
            untuned[("counting", "rmat16")] = (res.dist.cpu(),
                                               res.sigma.cpu(), res.sweeps)
        got = tally(by_graph, "rmat16", ckernels, before)
        emit(phase="counting", graph="rmat16", run=run, options=opts,
             seconds=wall, sweeps=res.sweeps,
             direction_counts=res.direction_counts.tolist(),
             max_sigma=max_sigma, sigma_exact_below=EXACT_F32,
             launches=got, index_launches=got["nonzero_words"],
             dist_sigma_checked_rows=int(len(check)))
        if got["nonzero_words"]:
            raise AssertionError(f"counting/{run}: the live-word index was "
                                 f"rebuilt during the run")
        del h
    base = cres["default"]
    for run in ("push", "fused"):
        r = cres[run]
        if not (torch.equal(r.dist, base.dist)
                and torch.equal(r.sigma, base.sigma)
                and r.sweeps == base.sweeps):
            raise AssertionError(f"counting/{run}: dist, sigma or sweeps "
                                 f"differ from the default run")
    if not torch.equal(cres["push"].direction_counts,
                       cres["fused"].direction_counts):
        raise AssertionError("counting: fused accounting differs from the "
                             "per-sweep push")
    del cres, base, r, res

    # -- centrality on rmat16 ------------------------------------------------
    csub = csrcs[:N_CENTRALITY]
    h = repro_torch.prepare(g)
    h.prepared()
    before = [k.launches for k in ckernels]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cent = h.centrality(csub)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    seconds_of[("centrality", "rmat16", "default")] = wall
    del h
    hdist, hsigma = host_counts(g, csub)
    want_bc = host_betweenness(g, csub, hdist, hsigma)
    bc_err = np.abs(cent.betweenness - want_bc)
    bc_rel = float((bc_err / np.maximum(np.abs(want_bc), 1e-300)).max())
    if not np.allclose(cent.betweenness, want_bc, rtol=BETWEENNESS_RTOL,
                       atol=0.0):
        raise AssertionError(f"centrality: betweenness differs from the "
                             f"float64 host Brandes (max rel {bc_rel})")
    want_ecc = scipy_dist(g, csub).max(axis=1)
    if not np.array_equal(cent.eccentricity, want_ecc):
        raise AssertionError("centrality: eccentricity differs from scipy")
    emit(phase="centrality", graph="rmat16", sources=int(len(csub)),
         measures=["closeness", "harmonic", "eccentricity", "betweenness"],
         seconds=wall, sweeps=cent.sweeps,
         sigma_checksum=cent.sigma_checksum, radius=cent.radius,
         diameter=cent.diameter, betweenness_max_rel_err=bc_rel,
         betweenness_rtol=BETWEENNESS_RTOL,
         launches=tally(by_graph, "rmat16", ckernels, before))
    claunches = {k.__name__: k.launches for k in ckernels}
    emit(phase="counting_path", launches=claunches)
    for k in ckernels:
        if claunches[k.__name__] < 1:
            raise AssertionError(f"{k.__name__} never launched on the "
                                 f"counting path")
    launches.update(claunches)

    # -- the weighted path: default, pinned dense / sparse, fused ------------
    wrng = np.random.default_rng(SEED)
    lanes_of = {name: (wrng.integers(4, 33, g.m_pad) / 8).astype(np.float32)
                for name, g in graphs.items()}
    wruns = {
        "rmat16": {
            "default": {},
            "dense": dict(mode="dense", use_kernel=True),
            "sparse": dict(mode="sparse", use_kernel=True),
            "fused": dict(fused_steps=-1),
        },
        "grid256": {
            "default": {},
            "sparse": dict(mode="sparse", use_kernel=True),
        },
    }
    tropical.reset_launches()
    for name, runs_w in wruns.items():
        g, lanes, wsrcs = graphs[name], lanes_of[name], srcs[name]
        check = wsrcs[:: len(wsrcs) // N_CHECK][:N_CHECK]
        want = scipy_dijkstra(g, lanes, check)
        # the replayed check run: the default options on the checked
        # sources alone, against the host's float32 Bellman-Ford
        hdist, hsweeps, htouched = host_minplus(g, lanes, check)
        if not np.array_equal(hdist.astype(np.float64), want):
            raise AssertionError(f"{name}: the host replay differs from "
                                 f"scipy Dijkstra")
        h = repro_torch.prepare(g, weights=lanes)
        before = [k.launches for k in wkernels]
        res = h.apsp(check, semiring="tropical")
        tally(by_graph, name, wkernels, before)
        touched = float(res.edges_touched)
        if not (np.array_equal(res.dist.cpu().numpy(), hdist)
                and res.sweeps == hsweeps
                and abs(touched - htouched) <= EDGES_RTOL * htouched):
            raise AssertionError(f"weighted/{name}: dist, sweeps or "
                                 f"edges_touched differ from the host "
                                 f"replay ({res.sweeps} vs {hsweeps}, "
                                 f"{touched} vs {htouched})")
        emit(phase="weighted_check", graph=name, sources=int(len(check)),
             sweeps=res.sweeps, host_sweeps=hsweeps,
             direction_counts=res.direction_counts.tolist(),
             edges_touched=touched, edges_touched_f64=htouched)
        del h, res
        wres = {}
        for run, opts in runs_w.items():
            h = repro_torch.prepare(g, weights=lanes, **opts)
            if run != "sparse":
                h.prepared_weighted().wdense     # operand build = set-up
            if run != "sparse":                  # K7 / K8's index, too
                h.prepared_weighted().wdense_index
            if run in ("default", "sparse"):     # and K9's where it runs
                h.prepared_weighted().relax_index
            before = [k.launches for k in wkernels]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = h.apsp(wsrcs, semiring="tropical")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            del h
            rows = torch.from_numpy(np.searchsorted(wsrcs, check)).cuda()
            got = res.dist[rows].cpu().numpy().astype(np.float64)
            if not np.array_equal(got, want):
                raise AssertionError(f"weighted/{name}/{run}: dist differs "
                                     f"from scipy Dijkstra")
            if not torch.isfinite(res.edges_touched):
                raise AssertionError(f"weighted/{name}/{run}: "
                                     f"edges_touched")
            wres[run] = res
            seconds_of[("tropical", name, run)] = wall
            if run == "default":
                untuned[("tropical", name)] = (res.dist.cpu(), None,
                                               res.sweeps)
            got = tally(by_graph, name, wkernels, before)
            emit(phase="weighted", graph=name, run=run, options=opts,
                 sources=int(len(wsrcs)), seconds=wall,
                 sweeps=res.sweeps,
                 direction_counts=res.direction_counts.tolist(),
                 edges_touched=float(res.edges_touched),
                 launches=got,
                 index_launches=got["finite_words"] + got["in_lanes"],
                 dist_checked_rows=int(len(check)))
            if got["finite_words"] or got["in_lanes"]:
                raise AssertionError(f"weighted/{name}/{run}: an index "
                                     f"was rebuilt during the run")
        base = wres["default"]
        for run, r in wres.items():
            if not torch.equal(r.dist, base.dist):
                raise AssertionError(f"weighted/{name}/{run}: dist differs "
                                     f"from the default run")
            # the per-sweep runs see the same frontiers in the same order
            if run != "fused" and float(r.edges_touched) != \
                    float(base.edges_touched):
                raise AssertionError(f"weighted/{name}/{run}: "
                                     f"edges_touched differs from the "
                                     f"default run")
        if "fused" in wres:
            per, fused = wres["dense"], wres["fused"]
            if per.sweeps != fused.sweeps or not torch.equal(
                    per.direction_counts, fused.direction_counts):
                raise AssertionError(f"weighted/{name}: fused accounting "
                                     f"differs from the pinned dense run")
        del wres, base, r, res
        torch.cuda.empty_cache()
    wlaunches = {k.__name__: k.launches for k in wkernels}
    emit(phase="weighted_path", launches=wlaunches)
    for k in wkernels:
        if wlaunches[k.__name__] < 1:
            raise AssertionError(f"{k.__name__} never launched on the "
                                 f"weighted path")
    launches.update(wlaunches)

    # -- each kernel against its plain version, full width -------------------
    pg = repro_torch.prepare(graphs["rmat16"]).prepared()
    at, n_pad = pg.adj_pull, pg.n_pad
    words = at.shape[1]
    mid_step = 2
    _, _, st = next(apsp_engine_blocks(pg, srcs["rmat16"][:128],
                                       config=EngineConfig(
                                           mode="pull", use_kernel=True,
                                           max_steps=mid_step)))
    f, d = st.frontier.contiguous(), st.dist.contiguous()
    s = f.shape[0]
    fp = pack_bits(f != 0)
    torch.cuda.synchronize()

    nz_at = (at != 0).to(torch.float32)       # (n_pad, W), exact counts
    sector = 8                                # words per 32 B DRAM sector

    def packed_need(fp_, d_, new_, nz_=nz_at):
        """Operand bytes and word ops one packed sweep needs on this state,
        under the live-word rule.  A pair (s, j) still unreached that
        misses must see every live (non-zero) operand word of column j
        where frontier row s is active; one that hits needs a single
        word.  Bytes, per column with an unreached target: where some
        pending row misses, the cheaper of the two ways to read the live
        words a missing row's frontier selects, the column's index
        entries (8 B per live word: position and value) or the 32 B
        sectors of its operand row that hold them; where every pending
        row hits, one sector.  Ops (an AND and a test per
        word): one for a hitting pair; for a missing pair every word where
        both frontier row s and in-neighbour row j are non-zero.  Also
        returns the bytes of the earlier rule, which charged every sector
        a missing row's frontier touches, zero words included."""
        unreached = d_ < 0
        hit = unreached & (new_ != 0)
        miss = (unreached & (new_ == 0)).to(torch.float32)
        act = fp_ != 0
        pad = -act.shape[1] % sector

        def sectors_of(mask):                # (rows, W) -> (rows, W / 8)
            return torch.nn.functional.pad(mask, (0, pad)).reshape(
                mask.shape[0], -1, sector).any(dim=2)

        miss_sec = ((miss.t() @ sectors_of(act).to(torch.float32)) > 0) \
            .sum(dim=1)                                      # (n_pad,)
        hit_col = hit.any(dim=0)
        old = 4 * sector * int(torch.where(miss_sec > 0, miss_sec,
                                           hit_col.to(miss_sec.dtype)).sum())
        live = nz_ > 0                                       # (n_pad, W)
        selected = ((miss.t() @ act.to(torch.float32)) > 0) & live
        sel_sec = sectors_of(selected).sum(dim=1).double()
        per_col = torch.where(
            miss.sum(dim=0) > 0,
            torch.minimum(4.0 * sector * sel_sec,
                          8.0 * live.sum(dim=1).double()),
            4.0 * sector * hit_col.double())
        both = act.to(torch.float32) @ nz_.t()               # (S, n_pad)
        ops = 2.0 * (float(hit.sum())
                     + float(both[miss > 0].double().sum()))
        return int(per_col.sum()), ops, old

    def state_bytes(s_, n_):
        return s_ * n_ * (4 + 1 + 4)         # dist in, new + dist out

    lib_f = f.to(torch.float16)
    lib_adj = pg.adj.to(torch.float16)
    library_ms = cuda_ms(torch, lambda: torch.matmul(lib_f, lib_adj), 3)
    del lib_adj

    rows_out = [dict(row, launches=launches["pack_frontier"],
                     launches_by_graph=by_graph.get("pack_frontier", {}))
                for row in packs]

    def flat(outs):
        for o in outs:
            yield from (flat(o) if isinstance(o, tuple) else (o,))

    def record(name, state, kern, plain, outs_k, outs_p, bytes_, ops, rate,
               reps, lib, plain_warm=True, **extra):
        outs_k, outs_p = list(flat(outs_k)), list(flat(outs_p))
        err = 0.0
        for a, b in zip(outs_k, outs_p):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"{name}: kernel differs from its "
                                     f"plain version")
            # equal entries (+inf ones included) differ by 0
            diff = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
            err = max(err, float(diff.max()))
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / rate * 1e3
        rows_out.append(dict(
            name=name, route="cuda", source=sources_of[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=err, ms=cuda_ms(torch, kern, reps),
            plain_ms=cuda_ms(torch, plain, 1, warm=plain_warm),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib, match=True, state=state,
            launches_by_graph=by_graph.get(name, {}),
            shape=dict(s=s, n_pad=n_pad, words=words), **extra))
        emit(phase="kernel", **rows_out[-1])

    # a live-word index: built once per prepared graph, timed alone
    def index_row(name, build, plain, operand, per_word, graph="rmat16"):
        got, want = build(), plain()
        if not (torch.equal(got.offsets, want.offsets)
                and torch.equal(got.words, want.words)
                and (got.values is None) == (want.values is None)
                and (got.values is None
                     or torch.equal(got.values, want.values))
                and got.rows_live == want.rows_live):
            raise AssertionError(f"{name}: index differs from its plain "
                                 f"version")
        rows = operand.shape[0]
        index_bytes = 4 * (rows + 1 + got.words.numel()
                           + (0 if got.values is None
                              else got.values.numel()))
        t_bytes = (operand.numel() * operand.element_size()
                   + index_bytes) / HBM_BYTES_PER_S * 1e3
        rows_out.append(dict(
            name=name, route="cuda", source=sources_of[name],
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=0.0, ms=cuda_ms(torch, build, 2),
            plain_ms=cuda_ms(torch, plain, 1), bound_ms=t_bytes,
            bound_by="bytes", library_ms=None, match=True,
            state=f"{graph}, the {operand.dtype} operand, n_pad {n_pad}",
            launches_by_graph=by_graph.get(name, {}),
            shape=dict(rows=rows, n_pad=n_pad, per_word=per_word),
            library_note="no single PyTorch call builds a compacted "
                         "per-row word list"))
        emit(phase="index", name=name, graph=graph,
             index_ms=rows_out[-1]["ms"],
             plain_ms=rows_out[-1]["plain_ms"],
             bound_ms=rows_out[-1]["bound_ms"], live_words=got.words.numel(),
             rows_live=got.rows_live, index_bytes=index_bytes,
             operand_bytes=operand.numel() * operand.element_size(),
             bitmap_bytes=rows * (operand.shape[1] // per_word) // 8,
             match=True)
        emit(phase="kernel", **rows_out[-1])
        return got

    # K9's in-lane index: built once per prepared weighted graph, timed
    # alone; a target's lanes may come in any order
    def lane_index_row(graph, g_, lw_):
        def build():
            return tropical.in_lanes(g_.src, g_.dst, lw_, n_pad)

        def plain():
            return TR.in_lanes_ref(g_.src, g_.dst, lw_, n_pad,
                                   tropical.kernel.HUB_LANES)

        got, want = build(), plain()
        if not all(torch.equal(a, b) for a, b in zip(
                TR.in_lanes_sorted(got), TR.in_lanes_sorted(want))):
            raise AssertionError("in_lanes: index differs from its plain "
                                 "version")
        lanes, pieces = int(got.offsets[-1]), got.pieces.shape[0]
        index_bytes = 8 * (n_pad + 1) + 8 * lanes + 8 * pieces
        lane_bytes = 12 * g_.m_pad              # src, dst, weight read once
        t_bytes = (lane_bytes + index_bytes) / HBM_BYTES_PER_S * 1e3
        rows_out.append(dict(
            name="in_lanes", route="cuda", source=sources_of["in_lanes"],
            replaces=REPLACES["in_lanes"], launches=launches["in_lanes"],
            max_abs_err=0.0, ms=cuda_ms(torch, build, 3),
            plain_ms=cuda_ms(torch, plain, 1), bound_ms=t_bytes,
            bound_by="bytes", library_ms=None, match=True,
            state=f"{graph}, the weighted CSR lanes, n_pad {n_pad}",
            launches_by_graph=by_graph.get("in_lanes", {}),
            shape=dict(m_pad=g_.m_pad, n_pad=n_pad, lanes=lanes,
                       hub_lanes=tropical.kernel.HUB_LANES,
                       hub_pieces=pieces),
            library_note="no single PyTorch call builds a CSC (a sort by "
                         "target is one argsort plus gathers)"))
        emit(phase="index", name="in_lanes", graph=graph,
             index_ms=rows_out[-1]["ms"], plain_ms=rows_out[-1]["plain_ms"],
             bound_ms=t_bytes, lanes=lanes,
             hub_lanes=tropical.kernel.HUB_LANES,
             hub_pieces=pieces, index_bytes=index_bytes,
             lane_bytes=lane_bytes, match=True)
        emit(phase="kernel", **rows_out[-1])
        return got

    n_run = 4                                 # sweeps per multi-sweep launch
    rmat_state = f"rmat16, S={s}, after {mid_step} sweeps"
    rmat_multi = f"{rmat_state}, {n_run} sweeps per launch"
    step = mid_step + 1
    wk = 4 if words % 8 else 8
    io = s * words * 4 + state_bytes(s, n_pad)

    # K1 / K2 read the packed operand's live-word index, built at set-up
    pidx = index_row("packed_live_words",
                     lambda: bovm.packed_live_words(at),
                     lambda: R.packed_live_words_ref(at), at, 1)

    def k1():
        return bovm.packed_push_sweep(fp, at, d, step, bs=128, bn=128, wk=wk,
                                      index=pidx)

    def k1_plain():
        return R.packed_pull_ref(fp, at, d, step)

    out1 = k1_plain()
    need_bytes, need_ops, old1 = packed_need(fp, d, out1[0])
    record("packed_push_sweep", rmat_state, k1, k1_plain, k1(), out1,
           io + need_bytes, need_ops, WORD_OPS_PER_S, 20, library_ms,
           device_ms=graph_ms(torch, k1, 20))

    def k2():
        return bovm.packed_pull_sweep(fp, at, d, step, bs=8, bn=128, wk=wk,
                                      index=pidx)

    record("packed_pull_sweep", rmat_state, k2, k1_plain, k2(), out1,
           io + need_bytes, need_ops, WORD_OPS_PER_S, 20, library_ms,
           device_ms=graph_ms(torch, k2, 20))

    def k3():
        return bovm.fused_boolean_multisweep(f, at, d, mid_step, n_run,
                                             bs=128, max_sweeps=n_run)

    def k3_plain():
        return R.fused_boolean_multisweep_ref(f, at, d, mid_step, n_run)

    def multi_need(fp_, at_, d_, nz_, step0, sweeps):
        """The packed need of the sweeps one multi-sweep launch runs on
        this state, one packed sweep each, to the first empty one."""
        b_, o_, old_ = 0, 0.0, 0
        for t in range(sweeps):
            new_t, d_next = R.packed_pull_ref(fp_, at_, d_, step0 + 1 + t)
            nb, no, nold = packed_need(fp_, d_, new_t, nz_)
            b_, o_, old_, d_ = b_ + nb, o_ + no, old_ + nold, d_next
            if not bool(new_t.any()):
                break
            fp_ = pack_bits(new_t != 0)
        return b_, o_, old_

    out3 = k3()
    b3, o3, old3 = multi_need(fp, at, d, nz_at, mid_step, n_run)
    record("fused_boolean_multisweep", rmat_multi, k3, k3_plain, out3,
           k3_plain(), io + b3, o3, WORD_OPS_PER_S, 3, None,
           library_note=MULTI_SWEEP_NOTE)

    adj = pg.adj
    bk = 128

    def k4():
        return bovm.fused_sweep(f, adj, d, step, bs=128, bn=128, bk=bk)

    def k4_plain():
        return R.sweep_ref(f, adj, d, step)

    # operand rows of the live k-blocks, in the 32-column sectors that
    # hold an unreached target
    f_occ = (f != 0).reshape(1, s, n_pad // bk, bk).any(dim=3).any(dim=1)
    live_k = int(f_occ.sum())
    open_cols = (d < 0).any(dim=0)
    unreached_cols = int(open_cols.sum())
    open_sectors = int(open_cols.reshape(-1, 32).any(dim=1).sum())
    k4_bytes = (s * n_pad + live_k * bk * open_sectors * 32
                + state_bytes(s, n_pad))
    k4_ops = 2.0 * s * live_k * bk * unreached_cols
    record("fused_sweep", rmat_state, k4, k4_plain, k4(), k4_plain(),
           k4_bytes, k4_ops, INT8_OPS_PER_S, 3, library_ms)

    # -- K1 / K2 / K3 on grid256's deep, thin state --------------------------
    # the per-sweep packed kernels and the fused one where most of their
    # main-path sweeps run: a thin frontier far from the sources
    gpg = repro_torch.prepare(graphs["grid256"]).prepared()
    gat = gpg.adj_pull
    _, _, gst = next(apsp_engine_blocks(gpg, srcs["grid256"],
                                        config=EngineConfig(
                                            mode="pull", use_kernel=True,
                                            max_steps=GRID_STEPS)))
    gf, gd = gst.frontier.contiguous(), gst.dist.contiguous()
    gfp = pack_bits(gf != 0)
    gnz = (gat != 0).to(torch.float32)
    gidx = index_row("packed_live_words",
                     lambda: bovm.packed_live_words(gat),
                     lambda: R.packed_live_words_ref(gat), gat, 1, "grid256")
    grid_state = f"grid256, S={gf.shape[0]}, after {GRID_STEPS} sweeps"
    gstep = GRID_STEPS + 1
    yard_note = "fp16 matmul of the rmat16 state: same shapes"

    def g1():
        return bovm.packed_push_sweep(gfp, gat, gd, gstep, bs=128, bn=128,
                                      wk=wk, index=gidx)

    def g1_plain():
        return R.packed_pull_ref(gfp, gat, gd, gstep)

    gout1 = g1_plain()
    gb1, go1, gold1 = packed_need(gfp, gd, gout1[0], gnz)
    record("packed_push_sweep", grid_state, g1, g1_plain, g1(), gout1,
           io + gb1, go1, WORD_OPS_PER_S, 20, library_ms,
           library_note=yard_note, device_ms=graph_ms(torch, g1, 20))

    def g2():
        return bovm.packed_pull_sweep(gfp, gat, gd, gstep, bs=8, bn=128,
                                      wk=wk, index=gidx)

    record("packed_pull_sweep", grid_state, g2, g1_plain, g2(), gout1,
           io + gb1, go1, WORD_OPS_PER_S, 20, library_ms,
           library_note=yard_note, device_ms=graph_ms(torch, g2, 20))

    def g3():
        return bovm.fused_boolean_multisweep(gf, gat, gd, GRID_STEPS,
                                             GRID_RUN, bs=128,
                                             max_sweeps=GRID_RUN)

    def g3_plain():
        return R.fused_boolean_multisweep_ref(gf, gat, gd, GRID_STEPS,
                                              GRID_RUN)

    gout3 = g3()
    gb3, go3, gold3 = multi_need(gfp, gat, gd, gnz, GRID_STEPS, GRID_RUN)
    record("fused_boolean_multisweep",
           f"{grid_state}, {GRID_RUN} sweeps per launch", g3, g3_plain,
           gout3, g3_plain(), io + gb3, go3, WORD_OPS_PER_S, 3, None,
           library_note=MULTI_SWEEP_NOTE)
    # K1 / K2 / K3's operand bytes, beside those of the earlier rule
    emit(phase="bound_recount", rule="per open column: the cheaper of "
         "its index entries and the sectors of the live words a missing "
         "row's frontier selects, or one sector if every pending row hits "
         "(earlier: every sector a missing row's frontier touches, zero "
         "words included)",
         packed_push_sweep={"rmat16": dict(operand_bytes=need_bytes,
                                           earlier_rule_bytes=old1),
                            "grid256": dict(operand_bytes=gb1,
                                            earlier_rule_bytes=gold1)},
         fused_boolean_multisweep={"rmat16": dict(operand_bytes=b3,
                                                  earlier_rule_bytes=old3),
                                   "grid256": dict(operand_bytes=gb3,
                                                   earlier_rule_bytes=gold3)},
         state_bytes=io)
    del gpg, gat, gst, gf, gd, gfp, gnz, gout1, gout3, gidx
    torch.cuda.empty_cache()

    # -- K5 / K6 on a mid-run counting state, full width ---------------------
    _, _, _, cst = next(counting_apsp_blocks(
        pg, srcs["rmat16"][:128], config=CentralityConfig(
            mode="push", use_kernel=True, max_steps=mid_step)))
    cf = cst.frontier.contiguous()
    cd, csg = (t.contiguous() for t in cst.dist)
    if not float(csg.max()) < EXACT_F32:
        raise AssertionError("mid-run state: counts not exact in float32")
    fs = torch.where(cf != 0, csg, 0.0)
    lane_src, lane_dst = pg.graph.src.long(), pg.graph.dst.long()
    torch.cuda.synchronize()

    def counting_need(f_, d_):
        """Operand bytes and f32 adds one counting sweep needs on this
        state.  Bytes: for every operand row k in any row's frontier, the
        32 B sectors (32 columns) that hold a non-zero byte in a column
        with an unreached target of any row.  Adds: one per (row s, edge
        k -> j) with k in s's frontier and j unreached in s; a zero
        operand byte needs none.  Also the bytes of the earlier, coarser
        rule, which charged every open sector of each active row, zeros
        included."""
        act = (f_ != 0).any(dim=0)
        open_col = (d_ < 0).any(dim=0)
        lane = act[lane_src] & open_col[lane_dst]
        sectors = torch.unique(lane_src[lane] * (n_pad // 32)
                               + lane_dst[lane] // 32).numel()
        old = int(act.sum()) * int(open_col.reshape(-1, 32).any(dim=1)
                                   .sum()) * 32
        adds = float(((f_[:, lane_src] != 0) & (d_[:, lane_dst] < 0)).sum())
        return sectors * 32, adds, old

    # K5 and K6 read the operand's live-word index, built at set-up
    cidx = index_row("nonzero_words", lambda: counting.nonzero_words(adj),
                     lambda: CR.nonzero_words_ref(adj), adj, 16)

    def listed_bytes(f_):
        """Bytes of the live words the index lists for the operand rows
        in any row's frontier: what the K5 / K6 push reads of the
        operand, once per group of 32 rows."""
        act = ((f_ != 0).any(dim=0)).nonzero().flatten()
        off = cidx.offsets.long()
        return 16 * int((off[act + 1] - off[act]).sum())

    def k5():
        return counting.fused_counting_sweep(fs, adj, cd, csg, step, bs=128,
                                             bn=128, bk=bk, index=cidx)

    def k5_plain():
        return CR.counting_sweep_ref(fs, adj, cd, csg, step)

    adj_f32 = adj.to(torch.float32)          # 17.2 GB, the yardstick only
    lib5 = cuda_ms(torch, lambda: torch.matmul(fs, adj_f32), 3)
    del adj_f32
    b5, o5, old5 = counting_need(cf, cd)
    record("fused_counting_sweep", rmat_state, k5, k5_plain, k5(),
           k5_plain(),
           s * n_pad * 21 + b5, o5, WORD_OPS_PER_S, 5, lib5,
           listed_bytes=listed_bytes(cf), max_sigma=float(csg.max()),
           sigma_exact_below=EXACT_F32)

    def k6():
        return counting.fused_counting_multisweep(
            cf, adj, (cd, csg), mid_step, n_run, bs=128, max_sweeps=n_run,
            index=cidx)

    def k6_plain():
        return CR.fused_counting_multisweep_ref(cf, adj, cd, csg, mid_step,
                                                n_run)

    # the sweeps the block needs on this state
    f_t, d_t, sg_t, b6, o6, old6 = cf, cd, csg, 0, 0.0, 0
    for t in range(n_run):
        nb, no, nold = counting_need(f_t, d_t)
        b6, o6, old6 = b6 + nb, o6 + no, old6 + nold
        f_t, d_t, sg_t = CR.counting_sweep_ref(
            torch.where(f_t != 0, sg_t, 0.0), adj, d_t, sg_t,
            mid_step + 1 + t)
        if not bool(f_t.any()):
            break
    record("fused_counting_multisweep", rmat_multi, k6, k6_plain, k6(),
           k6_plain(),
           s * n_pad * 18 + b6, o6, WORD_OPS_PER_S, 2, None,
           library_note=MULTI_SWEEP_NOTE)
    # K5 / K6's operand bytes, beside those of the earlier, coarser rule
    emit(phase="bound_recount", rule="sectors holding a non-zero byte in "
         "an open column (earlier: every open sector of an active row)",
         fused_counting_sweep=dict(operand_bytes=b5, open_sector_bytes=old5),
         fused_counting_multisweep=dict(operand_bytes=b6,
                                        open_sector_bytes=old6))
    # -- K7 / K8 / K9 on a mid-run tropical state, full width ----------------
    # free the boolean and counting operands before the 17.2 GB f32 one
    del adj, at, pg, lib_f, fs, cf, cd, csg, cst, f, d, fp, st, cidx, pidx
    torch.cuda.empty_cache()
    pw = repro_torch.prepare(graphs["rmat16"],
                             weights=lanes_of["rmat16"]).prepared_weighted()
    wd, lw = pw.wdense, pw.w_edges
    g = pw.graph
    wsrc = torch.from_numpy(srcs["rmat16"][:128].astype(np.int64)).cuda()
    f = torch.zeros((s, n_pad), dtype=torch.int8, device="cuda")
    f[torch.arange(s, device="cuda"), wsrc] = 1
    d = torch.where(f != 0, 0.0, float("inf")).to(torch.float32)
    ridx = lane_index_row("rmat16", g, lw)
    for _ in range(mid_step):
        f, d = tropical.sparse_relax_sweep(f, d, g.src, g.dst, lw,
                                           index=ridx)
    inf = torch.tensor(float("inf"), device="cuda")
    fd = torch.where(f != 0, d, inf)
    w_min = lw.min()
    torch.cuda.synchronize()

    def operand_rows(pw_):
        """Per operand row: its 32 B sectors holding a finite weight, and
        its lanes (the out-degree)."""
        g_ = pw_.graph
        spr = n_pad // 8
        lane_k = g_.src[: g_.n_edges].long()
        sec_key = torch.unique(lane_k * spr + g_.dst[: g_.n_edges].long()
                               // 8)
        return (torch.bincount(sec_key // spr, minlength=n_pad).double(),
                pw_.deg.double())

    sectors_k, deg_k = operand_rows(pw)

    def minplus_need(f_, d_, sectors_k=sectors_k, deg_k=deg_k):
        """Operand bytes and operations one min-plus sweep needs on this
        state.  Bytes: for every k where some row's frontier holds a
        finite distance, the 32 B sectors of operand row k that hold a
        finite weight.  Operations: one add and one min per (row s, edge
        k -> j) with k in s's frontier at a finite distance.  Also the
        lanes the sparse relax must read: 8 B (dst, weight) per out-lane
        and 8 B of offsets per such k."""
        act = (f_ != 0) & torch.isfinite(d_)
        act_k = act.any(dim=0).double()
        ops = 2.0 * float(act.double().sum(dim=0) @ deg_k)
        lane_bytes = 8.0 * float(act_k @ deg_k) + 8.0 * float(act_k.sum())
        return 32.0 * float(act_k @ sectors_k), ops, lane_bytes

    b7, o7, l9 = minplus_need(f, d)
    widx = index_row("finite_words", lambda: tropical.finite_words(wd),
                     lambda: TR.finite_words_ref(wd), wd, 4)

    def k7():
        return tropical.fused_minplus_sweep(fd, wd, d, w_min, bs=128,
                                            bn=128, bk=128, index=widx)

    def k7_plain():
        return TR.minplus_sweep_ref(fd, wd, d)

    out7 = k7_plain()
    record("fused_minplus_sweep", rmat_state, k7, k7_plain, k7(), out7,
           s * n_pad * 13 + b7, o7, WORD_OPS_PER_S, 3, None,
           plain_warm=False,
           library_note="no single PyTorch call computes a (min,+) product")

    def k8():
        return tropical.fused_minplus_multisweep(f, wd, d, mid_step, n_run,
                                                 bs=128, max_sweeps=n_run,
                                                 index=widx)

    def k8_plain():
        return TR.fused_minplus_multisweep_ref(f, wd, d, n_run)

    # the sweeps the block needs on this state
    f_t, d_t, b8, o8 = f, d, 0.0, 0.0
    for t in range(n_run):
        nb, no, _ = minplus_need(f_t, d_t)
        b8, o8 = b8 + nb, o8 + no
        f_t, d_t = tropical.sparse_relax_sweep(f_t, d_t, g.src, g.dst, lw,
                                               index=ridx)
        if not bool(f_t.any()):
            break
    record("fused_minplus_multisweep", rmat_multi, k8, k8_plain, k8(),
           k8_plain(),
           s * n_pad * 10 + b8, o8, WORD_OPS_PER_S, 1, None,
           plain_warm=False, library_note=MULTI_SWEEP_NOTE)

    def k9():
        return tropical.sparse_relax_sweep(f, d, g.src, g.dst, lw,
                                           index=ridx)

    def k9_plain():
        return TR.sparse_relax_ref(f, d, g.src, g.dst, lw)

    # yardstick: the scatter-min alone, on precomputed lane candidates
    src_l, dst_l = g.src.long(), g.dst.long()
    lcand = torch.where(f.t()[src_l] != 0, d.t()[src_l] + lw[:, None], inf)
    lacc = d.t().contiguous()
    lib9 = cuda_ms(torch, lambda: lacc.index_reduce_(0, dst_l, lcand,
                                                     "amin"), 5)
    del lcand, lacc
    lib9_note = "index_reduce_ amin on precomputed candidates: scatter only"
    record("sparse_relax_sweep", rmat_state, k9, k9_plain, k9(),
           k9_plain(),
           s * n_pad * 10 + l9, o7, WORD_OPS_PER_S, 20, lib9,
           library_note=lib9_note, device_ms=graph_ms(torch, k9, 20))

    # -- K9 on grid256's deep, thin weighted state ---------------------------
    del wd, fd, pw, widx, ridx
    torch.cuda.empty_cache()
    pw2 = repro_torch.prepare(graphs["grid256"],
                              weights=lanes_of["grid256"]).prepared_weighted()
    g2, lw2 = pw2.graph, pw2.w_edges
    gsrc = torch.from_numpy(srcs["grid256"].astype(np.int64)).cuda()
    f2 = torch.zeros((len(gsrc), n_pad), dtype=torch.int8, device="cuda")
    f2[torch.arange(len(gsrc), device="cuda"), gsrc] = 1
    d2 = torch.where(f2 != 0, 0.0, float("inf")).to(torch.float32)
    ridx2 = lane_index_row("grid256", g2, lw2)
    for _ in range(GRID_STEPS):
        f2, d2 = tropical.sparse_relax_sweep(f2, d2, g2.src, g2.dst, lw2,
                                             index=ridx2)
    _, o9g, l9g = minplus_need(f2, d2, *operand_rows(pw2))

    def g9():
        return tropical.sparse_relax_sweep(f2, d2, g2.src, g2.dst, lw2,
                                           index=ridx2)

    def g9_plain():
        return TR.sparse_relax_ref(f2, d2, g2.src, g2.dst, lw2)

    src_l, dst_l = g2.src.long(), g2.dst.long()
    lcand = torch.where(f2.t()[src_l] != 0, d2.t()[src_l] + lw2[:, None],
                        inf)
    lacc = d2.t().contiguous()
    lib9g = cuda_ms(torch, lambda: lacc.index_reduce_(0, dst_l, lcand,
                                                      "amin"), 5)
    del lcand, lacc
    gw_state = f"grid256, S={len(gsrc)}, after {GRID_STEPS} sweeps"
    record("sparse_relax_sweep", gw_state, g9, g9_plain, g9(), g9_plain(),
           s * n_pad * 10 + l9g, o9g, WORD_OPS_PER_S, 20, lib9g,
           library_note=lib9_note, device_ms=graph_ms(torch, g9, 20))

    # K7 / K8 on the same thin state, where the tuned weighted default
    # (K8 over the whole fixpoint) runs most of its sweeps
    wd2 = pw2.wdense
    widx2 = index_row("finite_words", lambda: tropical.finite_words(wd2),
                      lambda: TR.finite_words_ref(wd2), wd2, 4, "grid256")
    rows2 = operand_rows(pw2)
    fd2 = torch.where(f2 != 0, d2, inf)
    w_min2 = lw2.min()
    b7g, o7g, _ = minplus_need(f2, d2, *rows2)

    def g7():
        return tropical.fused_minplus_sweep(fd2, wd2, d2, w_min2, bs=128,
                                            bn=128, bk=128, index=widx2)

    def g7_plain():
        return TR.minplus_sweep_ref(fd2, wd2, d2)

    record("fused_minplus_sweep", gw_state, g7, g7_plain, g7(), g7_plain(),
           s * n_pad * 13 + b7g, o7g, WORD_OPS_PER_S, 3, None,
           plain_warm=False,
           library_note="no single PyTorch call computes a (min,+) product")

    def g8():
        return tropical.fused_minplus_multisweep(
            f2, wd2, d2, GRID_STEPS, GRID_WRUN, bs=128,
            max_sweeps=GRID_WRUN, index=widx2)

    def g8_plain():
        return TR.fused_minplus_multisweep_ref(f2, wd2, d2, GRID_WRUN)

    f_t, d_t, b8g, o8g = f2, d2, 0.0, 0.0
    for t in range(GRID_WRUN):
        nb, no, _ = minplus_need(f_t, d_t, *rows2)
        b8g, o8g = b8g + nb, o8g + no
        f_t, d_t = tropical.sparse_relax_sweep(f_t, d_t, g2.src, g2.dst, lw2,
                                               index=ridx2)
        if not bool(f_t.any()):
            break
    record("fused_minplus_multisweep",
           f"{gw_state}, {GRID_WRUN} sweeps per launch", g8, g8_plain, g8(),
           g8_plain(), s * n_pad * 10 + b8g, o8g, WORD_OPS_PER_S, 3, None,
           plain_warm=False, library_note=MULTI_SWEEP_NOTE)

    del pw2, g2, lw2, f2, d2, ridx2, gsrc, wd2, widx2, fd2, f_t, d_t
    torch.cuda.empty_cache()
    all_kernels = kernels + ckernels + wkernels
    by_path = {k.__name__: {} for k in all_kernels}
    for ks, path in ((kernels, "boolean"), (ckernels, "counting"),
                     (wkernels, "weighted")):
        for k in ks:
            by_path[k.__name__][path] = launches[k.__name__]

    def path_launches(path, before, zeros=False):
        got = {k.__name__: k.launches - b
               for k, b in zip(all_kernels, before)}
        for name_, c in got.items():
            if c or zeros:
                by_path[name_][path] = c
                launches[name_] += c
        return got

    # -- the low-level boolean paths: wcc, msbfs_kernel (K4), msbfs_packed
    # (K2) on rmat16 -------------------------------------------------------
    from repro_torch.core.wcc import wcc
    from scipy.sparse.csgraph import connected_components
    g = graphs["rmat16"]
    n, n_pad = g.n_nodes, g.n_padded()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = wcc(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_comp, lab = connected_components(g.to_scipy(), directed=True,
                                       connection="weak")
    first = np.full(n_comp, n, np.int64)
    np.minimum.at(first, lab, np.arange(n))
    if not np.array_equal(comp.labels.cpu().numpy(), first[lab]):
        raise AssertionError("wcc: labels differ from scipy's weak "
                             "components")
    emit(phase="wcc", graph="rmat16", seconds=wall, iters=comp.iters,
         n_components=int(n_comp))
    msrcs = srcs["rmat16"][:DYN_SOURCES]
    want = scipy_dist(g, msrcs)
    msrc_t = torch.from_numpy(msrcs.astype(np.int64)).cuda()
    adj = g.to_dense_padded(n_pad)               # operand build = set-up
    before = [k.launches for k in all_kernels]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bovm.msbfs_kernel(adj, msrc_t, max_steps=n_pad, bs=128, bn=128,
                            bk=128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = path_launches("msbfs_kernel", before)
    if not np.array_equal(res.dist[:, :n].cpu().numpy(), want):
        raise AssertionError("msbfs_kernel: dist differs from scipy BFS")
    if got["fused_sweep"] != res.sweeps or res.sweeps < 1:
        raise AssertionError(f"msbfs_kernel: {got['fused_sweep']} K4 "
                             f"launches for {res.sweeps} sweeps")
    emit(phase="msbfs_kernel", graph="rmat16", sources=int(len(msrcs)),
         seconds=wall, sweeps=res.sweeps, launches=got,
         dist_checked_rows=int(len(msrcs)))
    del adj, res
    at = g.to_pull_packed(n_pad)                 # operand build = set-up
    words = at.shape[1]
    before = [k.launches for k in all_kernels]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bovm.msbfs_packed(at, msrc_t, n_pad, max_steps=n_pad, bs=8,
                            bn=128, wk=4 if words % 8 else 8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = path_launches("msbfs_packed", before)
    if not np.array_equal(res.dist[:, :n].cpu().numpy(), want):
        raise AssertionError("msbfs_packed: dist differs from scipy BFS")
    if got["packed_pull_sweep"] != res.sweeps or res.sweeps < 1 or \
            got["packed_live_words"] != 1:
        raise AssertionError(f"msbfs_packed: {got['packed_pull_sweep']} K2 "
                             f"launches for {res.sweeps} sweeps, "
                             f"{got['packed_live_words']} index builds")
    emit(phase="msbfs_packed", graph="rmat16", sources=int(len(msrcs)),
         seconds=wall, sweeps=res.sweeps, launches=got,
         dist_checked_rows=int(len(msrcs)))
    del at, res, msrc_t
    torch.cuda.empty_cache()

    # -- the dynamic path: mutation and incremental repair, K9 resuming
    # each repair ----------------------------------------------------------
    dyn = [("rmat16", graphs["rmat16"], srcs["rmat16"][:DYN_SOURCES], None),
           ("grid256", graphs["grid256"], srcs["grid256"], None),
           ("rmat16", graphs["rmat16"], srcs["rmat16"][:DYN_SOURCES],
            lanes_of["rmat16"])]
    before = [k.launches for k in all_kernels]
    for name, g, dsrcs, lanes in dyn:
        stream = record_stream(g.n_nodes, DYN_ROUNDS, DYN_PER_ROUND, SEED)
        fields = dynamic_run(torch, repro_torch, tropical, name, g, dsrcs,
                             lanes, stream)
        emit(phase="dynamic", nvidia_smi=smi, **fields)
        torch.cuda.empty_cache()
    got = path_launches("dynamic", before)
    emit(phase="dynamic_path", launches=got)
    for name in ("sparse_relax_sweep", "in_lanes"):
        if got[name] < 1:
            raise AssertionError(f"{name} never launched on the dynamic "
                                 f"path")

    # -- the serving tier: GraphService over rmat16 (K1 and K9 flushes) ----
    g = graphs["rmat16"]
    emit(phase="serve_kernels", graph="rmat16",
         **serve_kernel_check(torch, repro_torch, g, lanes_of["rmat16"],
                              serve_stream(g.n_nodes, SERVE_QUERIES,
                                           SEED + 10, (0.6, 0.2, 0.2))[0]
                              [:SERVE_BATCH]))
    for mod in (bovm, counting, tropical):
        mod.reset_launches()
    before = [0] * len(all_kernels)
    for fields in serve_run(torch, repro_torch, all_kernels, g,
                            lanes_of["rmat16"]):
        emit(phase="serve", graph="rmat16", nvidia_smi=smi, **fields)
    got = path_launches("serve", before)
    emit(phase="serve_path", launches=got)
    for name in ("packed_push_sweep", "sparse_relax_sweep"):
        if got[name] < 1:
            raise AssertionError(f"{name} never launched on the serving "
                                 f"path")
    torch.cuda.empty_cache()

    # -- resumable jobs: checkpointed apsp, killed and resumed (K1, K5, K9)
    for mod in (bovm, counting, tropical):
        mod.reset_launches()
    before = [0] * len(all_kernels)
    for fields in jobs_run(torch, repro_torch, all_kernels, g,
                           lanes_of["rmat16"], srcs["rmat16"][:JOB_SOURCES]):
        emit(phase="jobs", graph="rmat16", nvidia_smi=smi, **fields)
    got = path_launches("jobs", before)
    emit(phase="jobs_path", launches=got)
    for name in ("packed_push_sweep", "fused_counting_sweep",
                 "sparse_relax_sweep"):
        if got[name] < 1:
            raise AssertionError(f"{name} never launched on the jobs path")
    torch.cuda.empty_cache()

    # -- the roofline autotuner: plans built, saved, loaded; the tuned
    # default runs fuse (K3, K6, K8) ----------------------------------------
    for mod in (bovm, counting, tropical):
        mod.reset_launches()
    before = [0] * len(all_kernels)
    for fields in tune_run(torch, repro_torch, all_kernels, graphs,
                           lanes_of, srcs, untuned, seconds_of, cent):
        emit(phase="tune", nvidia_smi=smi, **fields)
    got = path_launches("tune", before)
    emit(phase="tune_path", launches=got)
    for name in ("fused_boolean_multisweep", "fused_counting_multisweep",
                 "fused_minplus_multisweep"):
        if got[name] < 1:
            raise AssertionError(f"{name} never launched on the tune path")
    torch.cuda.empty_cache()

    # -- the sharded executor at world size 1: NCCL on a (1, 1) mesh (K1,
    # K3, K5, K7, K9), then the K-row blocks that C = 2 ranks run --------
    import datetime
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.core.distributed import sharded_apsp
    from repro_torch.launch.mesh import make_mesh
    nccl_dir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group(
        "nccl", init_method=f"file://{nccl_dir}/store", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        # the first collective of each process group builds its NCCL
        # communicator: set-up, timed apart from the runs
        t0 = time.perf_counter()
        sharded_apsp(gen.grid2d(8, 8, device="cuda"), [0], mesh=mesh)
        torch.cuda.synchronize()
        emit(phase="sharded_setup",
             nccl_first_call_seconds=time.perf_counter() - t0)
        for mod in (bovm, counting, tropical):
            mod.reset_launches()
        before = [0] * len(all_kernels)
        t0 = time.perf_counter()
        for fields in sharded_run(torch, repro_torch, all_kernels, graphs,
                                  lanes_of, srcs, untuned, seconds_of, cent,
                                  mesh):
            emit(phase="sharded", nvidia_smi=smi, **fields)
        got = path_launches("sharded", before)
        emit(phase="sharded_path", launches=got,
             seconds=time.perf_counter() - t0)
        for name in ("packed_push_sweep", "fused_boolean_multisweep",
                     "fused_counting_sweep", "fused_minplus_sweep",
                     "sparse_relax_sweep"):
            if got[name] < 1:
                raise AssertionError(f"{name} never launched on the sharded "
                                     f"path")
        # comparisons: their launches do not count
        counted = launch_counts(all_kernels)
        t0 = time.perf_counter()
        for fields in sharded_block_check(
                torch, graphs["rmat16"], lanes_of["rmat16"],
                srcs["rmat16"][:SHARDED_BLOCK_ROWS]):
            emit(phase="sharded_blocks", graph="rmat16", **fields)
        emit(phase="sharded_blocks_done", seconds=time.perf_counter() - t0)
        for k in all_kernels:
            k.launches = counted[k.__name__]
    finally:
        dist.destroy_process_group()
        shutil.rmtree(nccl_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    # -- graph files: rmat16 written, read back onto the card, prepared and
    # run (K1, K2, K3, K7, K9) -------------------------------------------
    for mod in (bovm, counting, tropical):
        mod.reset_launches()
    before = [0] * len(all_kernels)
    t0 = time.perf_counter()
    for fields in io_run(torch, repro_torch, all_kernels, graphs["rmat16"],
                         lanes_of["rmat16"], srcs["rmat16"],
                         untuned[("boolean", "rmat16")],
                         untuned[("tropical", "rmat16")]):
        emit(phase="io", graph="rmat16", nvidia_smi=smi, **fields)
    got = path_launches("io", before, zeros=True)
    emit(phase="io_path", launches=got, seconds=time.perf_counter() - t0)
    for name in ("packed_push_sweep", "packed_pull_sweep",
                 "fused_boolean_multisweep", "fused_minplus_sweep",
                 "sparse_relax_sweep"):
        if got[name] < 1:
            raise AssertionError(f"{name} never launched on the io path")
    del untuned
    torch.cuda.empty_cache()

    # -- the paper's experiment families (SUITE) against scipy's BFS -------
    for mod in (bovm, counting, tropical):
        mod.reset_launches()
    before = [0] * len(all_kernels)
    t0 = time.perf_counter()
    for fields in suite_run(torch, repro_torch, all_kernels):
        emit(phase="suite", nvidia_smi=smi, **fields)
    got = path_launches("suite", before, zeros=True)
    emit(phase="suite_path", launches=got, seconds=time.perf_counter() - t0)

    # -- GraphSAGE's fanout sampler on rmat16 -------------------------------
    for mod in (bovm, counting, tropical):
        mod.reset_launches()
    before = [0] * len(all_kernels)
    emit(phase="sample", graph="rmat16", nvidia_smi=smi,
         **sample_run(torch, graphs["rmat16"], srcs["rmat16"]))
    emit(phase="sample_path",
         launches=path_launches("sample", before, zeros=True))

    # -- the training substrate: optimizers, accumulation, resume,
    # compression, the mesh step -----------------------------------------
    for mod in (bovm, counting, tropical):
        mod.reset_launches()
    before = [0] * len(all_kernels)
    t0 = time.perf_counter()
    for fields in train_run(torch, smi):
        emit(phase="train", **fields)
    emit(phase="train_path",
         launches=path_launches("train", before, zeros=True),
         seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()

    # -- the user examples: examples/torch_*.py's main() on the card (K1
    # and K7 certain: distributed_dawn pins push and dense) ---------------
    for mod in (bovm, counting, tropical):
        mod.reset_launches()
    before = [0] * len(all_kernels)
    t0 = time.perf_counter()
    for fields in examples_run(torch, all_kernels):
        emit(phase="examples", nvidia_smi=smi, **fields)
    got = path_launches("examples", before, zeros=True)
    emit(phase="examples_path", launches=got,
         seconds=time.perf_counter() - t0)
    for name in ("packed_push_sweep", "fused_minplus_sweep"):
        if got[name] < 1:
            raise AssertionError(f"{name} never launched on the examples "
                                 f"path")
    torch.cuda.empty_cache()

    # launches of the comparisons above do not count: report those of the
    # paths' runs
    for row in rows_out:
        row["launches"] = launches[row["name"]]
        row["launches_by_path"] = by_path[row["name"]]

    print(json.dumps({"kernels": rows_out}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Sharded DAWN APSP over a mesh of ranks — the port's multi-device
execution path at demo scale.

The semiring-generic sharded executor runs the SAME sweep forms as the
single-device engines, sharded over sources (mesh axis ``data``) and
optionally over vertices (axis ``model``, cross-shard ⊕-reduction per
sweep), for both the boolean (unweighted BFS) and tropical ((min,+)
weighted) semirings.  Results are bit-identical to the single-device
engines — this script asserts it.

The PyTorch counterpart of ``examples/distributed_dawn.py``, SPMD over
``torch.distributed`` (one process per device, see ``_torch_world.py``).
On N ranks the meshes are (N,) ``data`` and (N/2, 2) ``data/model``;
at world size 1, (1,) and (1, 1):

    PYTHONPATH=src python examples/torch_distributed_dawn.py   # one card
    PYTHONPATH=src python examples/torch_distributed_dawn.py \
        --device cpu --ranks 8                      # 8 gloo ranks
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node=4 \
        examples/torch_distributed_dawn.py          # 4 cards
"""
import argparse
import sys
import time

import numpy as np
import torch

import _torch_world
import repro_torch as dawn
from repro_torch.graph import generators as gen
from repro_torch.launch.mesh import make_mesh


def _timed(tag, fn, device):
    fn()                                    # warm
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"{tag:42s}: {(time.perf_counter() - t0) * 1e3:7.1f} ms "
          f"({int(out.sweeps)} sweeps)")
    return out


def _meshes(world: int):
    """(N,) data, and (N/2, 2) data/model ((1, 1) at world size 1)."""
    model = 2 if world % 2 == 0 else 1
    return [((world,), ("data",)),
            ((world // model, model), ("data", "model"))]


def run(dev):
    import torch.distributed as dist
    g = gen.rmat(10, 8, directed=False, seed=7, device=dev)   # n = 1024
    w = np.random.default_rng(0).uniform(0.5, 4.0, g.m_pad).astype(
        np.float32)
    sources = np.arange(32, dtype=np.int32)
    print(f"graph: n={g.n_nodes} m={g.n_edges}, {len(sources)} sources")

    h = dawn.prepare(g, weights=w, mode="dense", source_batch=32,
                     device=dev)
    hp = dawn.prepare(g, mode="push", source_batch=32, device=dev)

    single_b = _timed("single-device boolean (push)",
                      lambda: hp.apsp(sources), dev)
    single_t = _timed("single-device tropical (dense)",
                      lambda: h.apsp(sources, semiring="tropical"), dev)

    for shape, axes in _meshes(dist.get_world_size()):
        mesh = make_mesh(shape, axes, device=dev.type)
        tag = "x".join(map(str, shape)) + " " + "/".join(axes)
        res_b = _timed(f"sharded boolean  mesh {tag}",
                       lambda: h.apsp(sources, mesh=mesh), dev)
        res_t = _timed(f"sharded tropical mesh {tag}",
                       lambda: h.apsp(sources, semiring="tropical",
                                      mesh=mesh), dev)
        assert torch.equal(res_b.dist, single_b.dist)
        assert torch.equal(res_t.dist, single_t.dist)
        assert int(res_b.sweeps) == int(single_b.sweeps)
        assert int(res_t.sweeps) == int(single_t.sweeps)

    print("sharded distances bit-identical to the single-device engines ✓")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    _torch_world.add_args(ap)
    args = ap.parse_args(argv)
    _torch_world.run(run, args, __file__, argv)


if __name__ == "__main__":
    main()

"""Preemption-safe checkpointed APSP — kill a job halfway, resume it
elastically on a SMALLER mesh, get bit-identical results.

A counting-semiring APSP job (dist + path counts — the betweenness
front half) runs in source-tile chunks through the resumable-job layer
(``core/jobs.py``), checkpointing every chunk (async writer, sha256
manifest, atomic rename).  This script:

  1. runs the job uninterrupted on a (N/2, 2) mesh (the reference),
  2. re-runs it with an injected preemption after half the chunks,
  3. "loses a host": plans a survivor mesh with ``plan_remesh`` and
     builds it with ``mesh_from_plan`` (N ranks -> N/2),
  4. resumes the SAME call on the survivor mesh — the restore walks the
     checkpoint through the new mesh — and asserts distances, path
     counts and sweep totals bit-identical to the uninterrupted run.

The PyTorch counterpart of ``examples/resumable_job.py``, SPMD over
``torch.distributed`` (see ``_torch_world.py``).  On 8 ranks it is the
JAX script's path: (4, 2), then the ``plan_remesh(4, model_parallel=2)``
survivor (2, 2).  A world too small to keep a model group of 2 (one
card: a (1, 1) mesh) cannot shrink: there the job runs uninterrupted,
is preempted at half the chunks and resumes on the same mesh, with the
same bit-identity asserted.

    PYTHONPATH=src python examples/torch_resumable_job.py      # one card
    PYTHONPATH=src python examples/torch_resumable_job.py \
        --device cpu --ranks 8                       # 8 gloo ranks
"""
import argparse
import sys

import numpy as np

import _torch_world
import repro_torch as dawn
from repro_torch.graph import generators as gen
from repro_torch.launch.mesh import make_mesh, mesh_from_plan
from repro_torch.train.fault_tolerance import plan_remesh


class Preempted(RuntimeError):
    pass


def kill_after(chunk_idx):
    def on_chunk(k):
        if k == chunk_idx:
            raise Preempted(f"SIGTERM after chunk {k}")
    return on_chunk


def run(dev):
    import torch.distributed as dist
    g = gen.rmat(8, 8, directed=False, seed=7, device=dev)   # n = 256
    sources = np.arange(32, dtype=np.int32)
    # direction_counts are only mesh-shape invariant under a fixed mode
    h = dawn.prepare(g, source_batch=8, mode="dense", device=dev)
    print(f"graph: n={g.n_nodes} m={g.n_edges}, {len(sources)} sources, "
          f"chunks of 8")

    world = dist.get_world_size()
    model = 2 if world % 2 == 0 else 1
    big = make_mesh((world // model, model), ("data", "model"),
                    device=dev.type)
    full = h.apsp(sources, semiring="counting", mesh=big)
    print(f"reference run on {'x'.join(map(str, big.shape))} mesh: "
          f"{int(full.sweeps)} sweeps")

    with _torch_world.shared_tempdir() as ckpt_dir:
        try:
            h.apsp(sources, semiring="counting", mesh=big,
                   checkpoint_dir=ckpt_dir, chunk_size=8,
                   on_chunk=kill_after(1))
        except Preempted as e:
            print(f"preempted: {e}")

        # half the fleet is gone — re-plan onto the survivors (a world
        # that cannot keep a whole model group on half resumes on all)
        alive = world // 2 if world // 2 >= model else world
        plan = plan_remesh(alive, model_parallel=model)
        small = mesh_from_plan(plan, device=dev.type)
        print(f"resuming on survivor mesh "
              f"{dict(zip(small.mesh_dim_names, small.shape))}")

        if small.get_coordinate() is not None:   # the survivors resume
            res = h.apsp(sources, semiring="counting", mesh=small,
                         checkpoint_dir=ckpt_dir, chunk_size=8)
            print(f"restored {res.chunks_restored} chunks from step "
                  f"{res.restored_step}, recomputed {res.chunks_computed}")

            assert (res.dist == full.dist.cpu().numpy()).all()
            assert (res.sigma == full.sigma.cpu().numpy()).all()
            assert res.sweeps == int(full.sweeps)
            assert res.chunks_restored == 2 and res.chunks_computed == 2

    print("resumed-on-smaller-mesh results bit-identical to the "
          "uninterrupted run ✓")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    _torch_world.add_args(ap)
    args = ap.parse_args(argv)
    _torch_world.run(run, args, __file__, argv)


if __name__ == "__main__":
    main()

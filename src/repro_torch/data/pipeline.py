"""Host→device pipeline: sharded placement + background prefetch (the
port of ``repro/data/pipeline.py``).

``shard_batch`` places a host batch on a mesh
(:func:`repro_torch.launch.mesh.make_mesh`) according to a dict of
:class:`~repro_torch.launch.mesh.PartitionSpec`: each tensor becomes a
``torch.distributed.tensor.DTensor`` whose local shard lies on this
rank's device of the mesh.  Every rank of the mesh calls it with the same
batch (the SPMD contract of the port's sharded code); each keeps its own
shard.  ``Prefetcher`` overlaps host batch synthesis with device compute
via a worker thread and a small queue (depth 2 keeps one batch in flight
without unbounded memory)."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..launch.mesh import PartitionSpec, check_mesh, mesh_device


def placements(mesh, spec: PartitionSpec, ndim: int) -> List:
    """The DTensor placements (one per mesh axis) of a tensor of ``ndim``
    dimensions laid out by ``spec``: ``Shard(d)`` on each axis that
    splits dimension ``d``, ``Replicate()`` on the others.  A dimension
    split over several axes names them in the mesh's order (the first is
    the major one, as in JAX); an axis splits at most one dimension."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    if len(spec) > ndim:
        raise ValueError(f"{spec} has {len(spec)} entries for a tensor of "
                         f"{ndim} dimensions")
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec):
        axes = () if part is None else \
            (part,) if isinstance(part, str) else tuple(part)
        pos = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: the mesh has no axis {a!r} "
                                 f"(axes {names})")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: axis {a!r} splits two "
                                 f"dimensions")
            out[i] = Shard(d)
            pos.append(i)
        if pos != sorted(pos):
            raise ValueError(f"{spec}: dimension {d} names its axes out of "
                             f"the mesh's order {names}")
    return out


def place(mesh, x, spec: Optional[PartitionSpec] = None):
    """``x`` (a tensor on any device, or an array) as a DTensor on
    ``mesh`` laid out by ``spec`` (``None``: replicated)."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.as_tensor(x).to(mesh_device(mesh))
    return distribute_tensor(t, mesh, placements(
        mesh, spec if spec is not None else PartitionSpec(), t.ndim))


def shard_batch(mesh, batch: Dict[str, np.ndarray],
                specs: Dict[str, PartitionSpec]):
    check_mesh(mesh)
    return {k: place(mesh, v, specs.get(k)) for k, v in batch.items()}


class Prefetcher:
    def __init__(self, it: Iterator, *, depth: int = 2,
                 place: Optional[Callable] = None):
        self.it = it
        self.place = place or (lambda x: x)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.done = False
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            for item in self.it:
                self.q.put(self.place(item))
        finally:
            self.q.put(StopIteration)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is StopIteration:
            raise StopIteration
        return item

"""What a cell drives: the system under test, or the control in its
place.  Each answers the traffic's queries by name (``apsp`` with a
list of sources, ``sssp`` with one) with ``(rows, counters)``: the
``(k, n)`` int32 distance rows, ``-1`` unreached, and the program's own
counters of the call.  A cell over several cards builds them with the
rank's mesh too, ``(src, dst, n, device, mesh)``: every rank builds one
and makes the same calls (:mod:`bench.world`)."""
from __future__ import annotations

import torch

from bench import reference


class Program:
    """``repro_torch``'s facade over the cell's graph, with its default
    options: ``prepare(CSRGraph.from_edges(...))``, then ``.apsp`` or
    ``.sssp``.  The loader gets both directions of every generated tuple,
    self-loops and duplicates included, as a user's load would."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int,
                 device: torch.device):
        import repro_torch
        s = torch.cat([src, dst]).cpu().numpy()
        d = torch.cat([dst, src]).cpu().numpy()
        self.graph = repro_torch.CSRGraph.from_edges(s, d, n, device=device)
        self.handle = repro_torch.prepare(self.graph, device=device)

    def apsp(self, sources):
        res = self.handle.apsp(sources)
        return res.dist, {"direction_counts": res.direction_counts.tolist(),
                          "sweeps": int(res.sweeps)}

    def sssp(self, source: int):
        return self.handle.sssp(source)[None], {}

    def close(self) -> None:
        self.handle = self.graph = None


class MeshProgram(Program):
    """The program on a mesh of cards: the same facade, each call with
    ``mesh=`` (the sharded executor: sources over the data axes, the sweep
    operand's K rows over ``model``).  Every rank gets the whole rows."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int,
                 device: torch.device, mesh):
        super().__init__(src, dst, n, device)
        self.mesh = mesh

    def apsp(self, sources):
        res = self.handle.apsp(sources, mesh=self.mesh)
        # the executor counts (dense, sparse) sweeps, its dense form being
        # the push product; the counter is (push, pull, sparse) as the
        # engine's
        dense, sparse = res.direction_counts.tolist()
        return res.dist, {"direction_counts": [dense, 0, sparse],
                          "sweeps": int(res.sweeps)}

    def sssp(self, source: int):
        return self.handle.sssp(source, mesh=self.mesh)[None], {}

    def close(self) -> None:
        super().close()
        self.mesh = None


class Control:
    """The reference in the program's place with one guarantee broken:
    each row stops one level short, so the farthest level of every source
    reads unreached.  On a mesh each rank searches alone."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int,
                 device: torch.device, mesh=None):
        self.g = reference.Graph(src.to(device), dst.to(device), n)

    def apsp(self, sources):
        return reference.bfs_rows(self.g, sources, levels_short=1), {}

    def sssp(self, source: int):
        return reference.bfs_rows(self.g, [source], levels_short=1), {}

    def close(self) -> None:
        self.g = None

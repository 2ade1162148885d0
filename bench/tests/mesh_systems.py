"""Systems that the multi-rank tests hand to :mod:`bench.world` (by
``module:class``): the program with a fault on one rank of the mesh.
Each rank imports this module; rank 1 is the one at fault."""
import os
import signal

import torch.distributed as dist

from bench import systems


class ZeroBlock(systems.MeshProgram):
    """Rank 1's block of the sweep operand built all zero: on a mesh that
    shards the operand, its K rows lose their edges; on one that does
    not, its share of the sources sees no edge."""

    def __init__(self, src, dst, n, device, mesh):
        from repro_torch.core import distributed
        build = distributed._dense_block

        def zeroed(*args, **kw):
            block = build(*args, **kw)
            return block.zero_() if dist.get_rank() == 1 else block
        distributed._dense_block = zeroed
        super().__init__(src, dst, n, device, mesh)


class RaiseInSetup(systems.MeshProgram):
    """Rank 1 raises while it builds the system."""

    def __init__(self, src, dst, n, device, mesh):
        if dist.get_rank() == 1:
            raise RuntimeError("rank 1 fails in set-up")
        super().__init__(src, dst, n, device, mesh)


class KilledInWindow(systems.MeshProgram):
    """Rank 1 is killed in its third call (the warm call is the first)."""

    calls = 0

    def apsp(self, sources):
        self.calls += 1
        if dist.get_rank() == 1 and self.calls == 3:
            os.kill(os.getpid(), signal.SIGKILL)
        return super().apsp(sources)

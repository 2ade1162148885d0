"""Share of rank 0's device busy time spent in the mesh's collectives
(NCCL's all-gathers and all-reduces), in percent: the program's
``dawn.mesh.gather`` and ``dawn.mesh.reduce`` spans, timed on the card
between events around each collective, over the busy time of rank 0's
trace.  A collective runs from when its rank reaches it until the slowest
rank has, so the share holds rank 0's waits on the other ranks as well
as the transfers.  (The trace's breakdown lists only the ten ops with the
most device time, and NCCL's kernels are not among them.)"""

SPANS = ("dawn.mesh.gather", "dawn.mesh.reduce")


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:            # a program without the recorder
        return None
    spans = trace.snapshot()["window"]["spans"]
    got = [spans[k]["s"] for k in SPANS if k in spans]
    if not got or ctx.summary is None or ctx.summary.busy_s <= 0:
        return None
    return 100.0 * sum(got) / ctx.summary.busy_s

"""The process world of the port's mesh examples (``torch_distributed_dawn``
and ``torch_resumable_job``).

The port runs SPMD, one process per device: every rank makes the same
calls.  Where the JAX examples fake 8 host devices in one process, these
take ``--ranks N``:

  * ``--ranks 1`` (the default) runs in this process at world size 1.  A
    default process group that already exists is reused (a program that
    set one up calls ``main``); otherwise one is set up through a
    ``file://`` store (NCCL on the card, gloo with ``--device cpu``) and
    torn down at the end.
  * ``--ranks N`` spawns N processes of the script, one per rank, joined
    through a ``file://`` store with a 60 s group timeout; rank 0 prints,
    and a rank that fails, or runs past ``RANKS_TIMEOUT_S``, fails the
    run.  On the card each rank takes ``cuda:<rank>``.
  * Under ``python -m torch.distributed.run --nproc-per-node=N`` the
    launcher's environment sets the world; only rank 0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

GROUP_TIMEOUT_S = 60          # a collective waits this long for a rank
RANKS_TIMEOUT_S = 600         # the spawned ranks' whole run


def add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU (gloo between ranks); "
                         "default: the card (NCCL)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes (ranks) in the world; 1 runs here")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)


def _backend(device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _spawn(script: str, argv, ranks: int) -> None:
    """Run ``script argv`` as ``ranks`` processes; rank 0's output is
    this process's."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="dawn-world-"))
    try:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        logs = [open(tmp / f"rank{r}.err", "w+") for r in range(ranks)]
        procs = [subprocess.Popen(
            [sys.executable, script, *argv, "--rank", str(r),
             "--store", str(tmp / "store")], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL, stderr=logs[r])
            for r in range(ranks)]
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        errors = []
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                p.wait()
            if p.returncode:
                logs[r].seek(0)
                errors.append(f"rank {r} exited {p.returncode}:\n"
                              f"{logs[r].read()[-3000:]}")
        for f in logs:
            f.close()
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(body, args, script: str, argv) -> None:
    """Call ``body(device)`` on every rank of the world ``args`` asks for
    (see the module docstring).  ``device`` is this rank's device."""
    import torch
    import torch.distributed as dist
    from repro_torch.graph.csr import resolve_device

    device = resolve_device(args.device)
    launched = "WORLD_SIZE" in os.environ          # torch.distributed.run
    if args.ranks > 1 and args.store is None and not launched:
        _spawn(script, list(argv), args.ranks)
        return
    own = not dist.is_initialized()
    scratch = None
    if own:
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        rank = int(os.environ.get("LOCAL_RANK", 0)) if launched \
            else args.rank or 0
        if device.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        if launched:
            dist.init_process_group(_backend(device), timeout=timeout)
        else:
            store = args.store
            if store is None:
                scratch = tempfile.mkdtemp(prefix="dawn-world-")
                store = os.path.join(scratch, "store")
            dist.init_process_group(
                _backend(device), init_method=f"file://{store}", rank=rank,
                world_size=args.ranks if args.store else 1, timeout=timeout)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        if dist.get_rank() == 0:
            body(device)
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                body(device)
    finally:
        if own:
            dist.destroy_process_group()
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)


@contextlib.contextmanager
def shared_tempdir():
    """A directory every rank of the default group shares: rank 0 makes
    it, the others get its path, and rank 0 removes it once all are
    done."""
    import torch.distributed as dist
    path = [tempfile.mkdtemp(prefix="dawn-job-")
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(path, src=0)
    try:
        yield path[0]
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(path[0], ignore_errors=True)

"""The check's control, at a cell's own size: the reference in the
program's place with one guarantee broken (:class:`bench.systems.Control`:
every row stops one level short), through the rest of a run, on each of
the given seeds in one process.  A cell whose configuration names a
``mesh`` runs it one rank a card, as its runs do (:mod:`bench.world`).
Each seed prints one JSON line with the numbers the check compared; the
control has to come out not correct.

    python3 bench/control.py --workload kron18.msbfs --seconds 5 \
        --seeds 11 12 13
"""
import time

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import run  # noqa: E402

CONTROL = "bench.systems:Control"


def control(cfg: dict, mix: dict, e2e: list, layer: list, *, seed: int,
            seconds: float, mesh=None, device: str = "cuda",
            limit_s: float = None) -> dict:
    """One seed's run of the cell with the control in the program's place
    -> its result; on one card in this process, over a ``mesh`` one rank
    a card."""
    from bench import systems, world
    if mesh is None:
        result, _ = run.run_cell(
            cfg, mix, e2e, layer, seed=seed, seconds=seconds, trace=False,
            device=device, t0=time.perf_counter(), system=systems.Control)
        return result
    rc, out = world.launch(
        {"config": cfg, "mix": mix, "e2e": e2e, "layer": layer,
         "seed": seed, "seconds": seconds, "trace": False, "device": device,
         "system": CONTROL, "t0": world.monotonic()},
        limit_s=limit_s or world.LIMIT_S)
    if rc:
        raise RuntimeError(f"the control's ranks exited {rc}: no result")
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from bench import manifest
    m = manifest.load()
    cell = manifest.workload(m, args.workload)
    cfg = manifest.config(m, cell["config"])
    mesh = manifest.layout(cell, cfg)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s): no "
              f"result", file=sys.stderr)
        return 2
    sys.path.insert(0, str(run.ROOT / "src"))
    e2e, layer = manifest.cell_metrics(m, args.workload)
    for seed in args.seeds:
        result = control(cfg, manifest.traffic(cell["traffic"]), e2e, layer,
                         seed=seed, seconds=args.seconds, mesh=mesh)
        print(json.dumps({"workload": args.workload,
                          "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The check's control, at a cell's own size: the reference in the
program's place with one guarantee broken (:class:`bench.systems.Control`:
every row stops one level short), through the rest of a run, on each of
the given seeds in one process.  Each seed prints one JSON line with the
numbers the check compared; the control has to come out not correct.

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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from bench import manifest, systems
    m = manifest.load()
    cell = manifest.workload(m, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: no result", file=sys.stderr)
        return 2
    sys.path.insert(0, str(run.ROOT / "src"))
    e2e, layer = manifest.cell_metrics(m, args.workload)
    for seed in args.seeds:
        result, _ = run.run_cell(
            manifest.config(m, cell["config"]),
            manifest.traffic(cell["traffic"]), e2e, layer, seed=seed,
            seconds=args.seconds, trace=False, t0=time.perf_counter(),
            system=systems.Control)
        print(json.dumps({"workload": args.workload,
                          "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

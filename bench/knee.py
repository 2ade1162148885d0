"""The knee of an open-loop cell: the highest Poisson rate at which, over a
window of ``--seconds``, at least 99 % of the queries due complete within
1 s of the window's close and the p95 latency stays within 4x its value
at the first rate.  The rate doubles from ``START`` until one fails,
then the bracket is bisected until it is within ``WITHIN`` of its lower
end.  One process; each rate a whole run of the cell (set-up, window,
check) with the mix's ``rate_per_s`` replaced, on the same seed, the drain
cut at 1 s.  Each rate prints one JSON line, and the knee a last one.

    python3 bench/knee.py --workload kron18.serve --seed 5 --seconds 51
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import run  # noqa: E402

SHARE = 0.99        # of the queries due, complete within 1 s of the close
TAIL = 4.0          # the p95 at most this many times the first rate's
LATE_S = 1.0
START = 250.0       # queries a second
WITHIN = 0.10
MOST = 64000.0


def probe(cfg, mix, e2e, rate: float, *, seed: int, seconds: float) -> dict:
    from bench import queries
    kind = queries.find(mix["query"])
    t0 = time.perf_counter()
    result, _, win = kind.measure(
        cfg, dict(mix, rate_per_s=rate), e2e, [], seed=seed,
        seconds=seconds, trace=False, t0=t0, drain_s=LATE_S)
    on_time = int(((win.status == kind.DONE)
                   & (win.done <= win.closed + LATE_S)).sum())
    lat = kind.latencies_ms(win)
    return {"rate_per_s": rate, "due": len(win.due),
            "complete_share": on_time / max(1, len(win.due)),
            "p50_ms": float(np.median(lat)),
            "p95_ms": result["metrics"]["open_loop_p95_ms"]["value"],
            "correct": result["correct"], "checks": result["checks"],
            "setup_s": result["metrics"]["setup_s"]["value"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from bench import manifest
    m = manifest.load()
    cell = manifest.workload(m, args.workload)
    cfg = manifest.config(m, cell["config"])
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device: no result", file=sys.stderr)
        return 2
    sys.path.insert(0, str(run.ROOT / "src"))
    e2e, _ = manifest.cell_metrics(m, args.workload)
    mix = manifest.traffic(cell["traffic"])
    print(f"card: {run.card_power()}", file=sys.stderr, flush=True)

    first = None

    def holds(rate: float) -> bool:
        nonlocal first
        r = probe(cfg, mix, e2e, rate, seed=args.seed, seconds=args.seconds)
        torch.cuda.empty_cache()
        if first is None:
            first = r["p95_ms"]
        r["sustained"] = r["complete_share"] >= SHARE and \
            r["p95_ms"] <= TAIL * first
        print(json.dumps(r), flush=True)
        return r["sustained"]

    good, bad = None, None
    rate = START
    while rate <= MOST:
        if not holds(rate):
            bad = rate
            break
        good, rate = rate, 2 * rate
    while good is not None and bad is not None and \
            (bad - good) / good > WITHIN:
        mid = (good + bad) / 2
        if holds(mid):
            good = mid
        else:
            bad = mid
    print(json.dumps({"knee_per_s": good, "first_failing_per_s": bad,
                      "p95_at_start_ms": first}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

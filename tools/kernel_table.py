#!/usr/bin/env python3
"""Rank the port's kernels by the time they lose on ``chip_smoke.py``'s
main path, per graph, from the log of one run.

    python3 chip_smoke.py > smoke.log
    python3 tools/kernel_table.py smoke.log

For each kernel line (one per kernel and timed state) it prints the
kernel's main-path launches on that state's graph, its time and bound
there, ``launches x (ms - bound_ms)``, and the wall time of the run pinned
to that kernel on that graph, scaled to all of the kernel's launches
there.  A timed state is one point of a run (often its widest frontier),
so the time lost per graph is the smaller of the two; a multi-sweep
launch (K3, K6, K8) runs a whole fused run while its line times a few
sweeps, so for those the scaled wall time alone counts.  A graph with
launches but no timed state of its own is priced at the other graph's
state and marked so.
"""
from __future__ import annotations

import json
import sys
from collections import defaultdict

# kernel -> (phase, run) whose wall time is that kernel's on the main path
PINNED = {
    "packed_push_sweep": ("apsp", "push"),
    "packed_pull_sweep": ("apsp", "pull"),
    "fused_boolean_multisweep": ("apsp", "fused"),
    "fused_counting_sweep": ("counting", "push"),
    "fused_counting_multisweep": ("counting", "fused"),
    "fused_minplus_sweep": ("weighted", "dense"),
    "fused_minplus_multisweep": ("weighted", "fused"),
    "sparse_relax_sweep": ("weighted", "sparse"),
}
MULTI = {"fused_boolean_multisweep", "fused_counting_multisweep",
         "fused_minplus_multisweep"}


def main(path: str) -> int:
    phases, kernels = {}, []
    for line in open(path):
        line = line.strip()
        if not line.startswith("{"):
            continue
        row = json.loads(line)
        if row.get("phase") in ("apsp", "counting", "weighted"):
            phases[(row["phase"], row["graph"], row["run"])] = \
                (row["seconds"], row["launches"])
        elif row.get("phase") == "kernel":
            kernels.append(row)
    timed = defaultdict(dict)                 # name -> graph -> row
    for row in kernels:
        timed[row["name"]][row["state"].split(",")[0]] = row
    lost = defaultdict(float)
    print("kernel | graph | launches | ms | bound_ms | launches x "
          "(ms - bound) s | pinned run s (its launches) | lost s")
    for name, by_state in timed.items():
        any_row = next(iter(by_state.values()))
        for graph, n in any_row["launches_by_graph"].items():
            row = by_state.get(graph) or any_row
            note = "" if graph in by_state else " (priced at " + \
                row["state"].split(",")[0] + ")"
            est = n * (row["ms"] - row["bound_ms"]) / 1e3
            phase, run = PINNED.get(name, ("", ""))
            wall, runs = phases.get((phase, graph, run), (None, {}))
            pinned = runs.get(name, 0)
            scaled = wall * n / pinned if wall is not None and pinned \
                else None
            cost = scaled if name in MULTI and scaled is not None else \
                min(est, scaled) if scaled is not None else est
            lost[name] += cost
            print(f"{name} | {graph}{note} | {n} | {row['ms']} | "
                  f"{row['bound_ms']} | {est} | {wall} ({pinned}) | "
                  f"{cost}")
    print()
    print("time lost, largest first:")
    for name, cost in sorted(lost.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {cost} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))

"""``BENCHMARK.json`` and the files it names, found by name.

A configuration ``<c>`` is ``bench/configs/<c>.json`` (its ``file`` in
the manifest), its generator ``bench/gen/<generator>.py``, a traffic mix
``<t>`` is ``bench/traffic/<t>.json`` and a per-layer metric ``<m>`` is
read by ``bench/metrics/<m>.py``.  Adding any of them adds files and
entries; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(manifest["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _module(path: Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str) -> ModuleType:
    return _module(BENCH / "gen" / f"{name}.py", f"bench_gen_{name}")


def reader(metric: str) -> ModuleType:
    return _module(BENCH / "metrics" / f"{metric}.py",
                   "bench_metric_" + metric.replace(".", "_"))


def cell_metrics(manifest: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and the per-layer metrics that ``cell`` reports."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return e2e, layer

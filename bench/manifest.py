"""``BENCHMARK.json`` and the files it names, found by name.

A configuration ``<c>`` is ``bench/configs/<c>.json`` (its ``file`` in
the manifest), its generator ``bench/gen/<generator>.py``, a traffic mix
``<t>`` is ``bench/traffic/<t>.json`` and a per-layer metric ``<m>`` is
read by ``bench/metrics/<m>.py``.  Adding any of them adds files and
entries; nothing here changes.  A configuration that names a ``mesh``
runs over that many cards (:func:`layout`).
"""
from __future__ import annotations

import importlib.util
import json
import math
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


def layout(cell: dict, cfg: dict):
    """The mesh ``cell`` runs on: its configuration's ``mesh``, ``{"shape":
    [1, 4], "axes": ["data", "model"]}`` (the axes that
    ``repro_torch.launch.mesh.make_mesh`` takes; ``model`` shards the sweep
    operand), or None for one card.  A cell's ``chips`` is the product of
    the shape; a configuration with no mesh runs on one card.  Anything
    else is a ``ValueError``, before a card is touched."""
    mesh, chips = cfg.get("mesh"), cell["chips"]
    if mesh is None:
        if chips != 1:
            raise ValueError(
                f"{cell['name']}: {chips} chips, but configuration "
                f"{cell['config']!r} names no mesh: a configuration without "
                f"one runs on one card")
        return None
    shape, axes = mesh.get("shape"), mesh.get("axes")
    if set(mesh) != {"shape", "axes"} or not isinstance(shape, list) \
            or not isinstance(axes, list) or not shape \
            or len(axes) != len(shape) or len(set(axes)) != len(axes) \
            or not all(type(s) is int and s >= 1 for s in shape) \
            or not all(isinstance(a, str) and NAME.fullmatch(a)
                       for a in axes):
        raise ValueError(
            f"configuration {cell['config']!r}: mesh {mesh!r} is not "
            f'{{"shape": [ints >= 1], "axes": [as many distinct names]}}')
    size = math.prod(shape)
    if size != chips:
        raise ValueError(
            f"{cell['name']}: {chips} chips, but the mesh {shape} of "
            f"configuration {cell['config']!r} holds {size} cards")
    return mesh


def cell_metrics(manifest: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """The end-to-end and the per-layer metrics that ``cell`` reports."""
    e2e = [m for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return e2e, layer

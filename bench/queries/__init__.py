"""Query kinds that run open loop, one module each.

A mix whose ``query`` is ``<q>`` is run by ``bench/queries/<q>.py`` where
that file exists; ``apsp`` and ``sssp`` have none and run closed loop
(:mod:`bench.driver`).  Such a module reads its own mix keys, refusing any
other, and gives ``run_cell`` with the arguments and the result of
:func:`bench.run.run_cell`: ``(cfg, mix, e2e, layer, *, seed, seconds,
trace, device, t0, system, log) -> (result dict, checks)``.  A new kind is
a new file here; no other file changes.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Optional

from bench.manifest import NAME

HERE = Path(__file__).resolve().parent


def find(query: str) -> Optional[ModuleType]:
    """The module of ``query``, or None for a closed-loop query."""
    if not NAME.fullmatch(query) or not (HERE / f"{query}.py").is_file():
        return None
    return importlib.import_module(f"bench.queries.{query}")

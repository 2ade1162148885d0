"""The ``kron20`` configuration and the readers of ``kron20.msbfs-4`` on
the CPU.  The configuration file itself runs on four gloo ranks through
:func:`bench.world.launch`, on the (1, 4) mesh it names, with only its
scale cut to 11 here: n_pad 2,560, so that each of the four K-row blocks
holds real vertices (at SCALE 9 the third and fourth would be all
padding), and it comes out correct against the reference.  A traced
(1, 2) world gives the cell's program readers their numbers; the device
readers, which find nothing on the CPU, are held to a summary made here."""
import json
import os
from types import SimpleNamespace

import pytest

from bench import manifest, run, world
from bench.tests.test_cellbench_run import M, POOL, SOURCES

CELL = "kron20.msbfs-4"
SCALE = 11
LIMIT_S = 240
PROGRAM_READERS = ("gather_mib.mesh", "block_build_s.mesh",
                   "sweep_span_us.mesh")
# these need the card's busy time, which a CPU trace does not have
DEVICE_READERS = ("nccl_pct.mesh", "call_roofline.mesh",
                  "device_idle_pct.mesh")


def kron20_cell(*, mesh=None, trace=False):
    w = manifest.workload(M, CELL)
    cfg = dict(manifest.config(M, w["config"]), scale=SCALE)
    if mesh is not None:
        cfg["mesh"] = dict(cfg["mesh"], shape=mesh)
    mix = dict(manifest.traffic(w["traffic"]),
               sources_per_call=SOURCES[w["traffic"]],
               key_pool=POOL[w["traffic"]])
    e2e, layer = manifest.cell_metrics(M, CELL)
    return {"config": cfg, "mix": mix, "e2e": e2e, "layer": layer,
            "seed": 2**31 + 29, "seconds": 0.5, "trace": trace,
            "device": "cpu", "system": world.SYSTEM, "t0": world.monotonic()}


def launched(cell, directory):
    err = directory / "rank0.err"
    with open(err, "w") as f:
        rc, out = world.launch(cell, limit_s=LIMIT_S, err=f,
                               env=dict(os.environ, OMP_NUM_THREADS="1"))
    lines = out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.read_text()


def test_the_cell_reports_what_its_metrics_name():
    e2e, layer = manifest.cell_metrics(M, CELL)
    assert {m["name"] for m in e2e} == {"gteps", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in layer} == set(PROGRAM_READERS) | \
        set(DEVICE_READERS)
    w = manifest.workload(M, CELL)
    assert manifest.layout(w, manifest.config(M, w["config"])) == {
        "shape": [1, 4], "axes": ["data", "model"]}


def test_the_config_file_is_correct_on_four_ranks(tmp_path):
    cell = kron20_cell()
    assert cell["config"]["mesh"]["shape"] == [1, 4]
    rc, result, err = launched(cell, tmp_path)
    assert rc == 0, err[-3000:]
    assert result["correct"], result
    checks = result["checks"]
    assert checks["wrong_entries"]["value"] == 0
    assert checks["rows_compared"]["value"] >= 1
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"gteps", "peak_mem_gib", "setup_s"}
    assert result["device"]["count"] == 4
    assert f"n {2**SCALE}, " in err


def test_the_program_readers_read_a_traced_world(tmp_path):
    """On a (1, 2) mesh each sweep gathers the other rank's packed words:
    24 rows of n_pad / 32 = 72 words of 4 B (n_pad 2,304), and the
    result's gather over the data axis of extent 1 receives nothing."""
    rc, result, err = launched(kron20_cell(mesh=[1, 2], trace=True),
                               tmp_path)
    assert rc == 0, err[-3000:]
    assert result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(PROGRAM_READERS) <= set(got), got
    assert got["gather_mib.mesh"] == 24 * 72 * 4 / 2**20
    assert got["block_build_s.mesh"] > 0
    assert got["sweep_span_us.mesh"] > 0
    # no device on the CPU: the device readers find nothing to read
    assert not set(DEVICE_READERS) & set(got)


def _summary(ops, busy_s=2.0, window_s=4.0):
    return SimpleNamespace(busy_s=busy_s, window_s=window_s,
                           n_device_ops=len(ops), device_ops=ops)


def test_the_device_readers_read_a_summary(monkeypatch):
    """The collectives' spans (host-timed here, on the card's clock on a
    card) over rank 0's busy time; the roofline and the idle share over
    the cards' mean seconds."""
    import time

    import torch

    from bench import yardstick
    from repro_torch import trace
    monkeypatch.setattr(yardstick, "call_bytes", lambda g, s: None)
    monkeypatch.setattr(yardstick, "least_seconds", lambda b, kind: 0.25)
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for name in ("dawn.mesh.gather", "dawn.mesh.reduce",
                     "dawn.mesh.combine"):
            with trace.device_span(name, torch.device("cpu")):
                time.sleep(0.01)
    spans = trace.snapshot()["window"]["spans"]
    rank0 = _summary([("packed_sweep_kernel", 1.0)])
    calls = [(0, SimpleNamespace(sources=None))] * 4
    ctx = run.Context(calls, {}, rank0, None, "H100", 4, (1.6, 3.2))
    read = {name: manifest.reader(name).read(ctx) for name in DEVICE_READERS}
    trace.reset()
    collectives = spans["dawn.mesh.gather"]["s"] + \
        spans["dawn.mesh.reduce"]["s"]
    assert collectives >= 0.02
    assert read["nccl_pct.mesh"] == 100.0 * collectives / 2.0
    assert read["call_roofline.mesh"] == 100.0 * 1.0 / 4 / 1.6
    assert read["device_idle_pct.mesh"] == 100.0 * (1 - 1.6 / 3.2)


@pytest.mark.parametrize("summary", [None, _summary([], busy_s=0.0),
                                     _summary([("k1", 1.0)])],
                         ids=["no_trace", "no_device_op", "no_collective"])
def test_the_device_readers_find_nothing_to_read(summary):
    from repro_torch import trace
    trace.reset()
    ctx = run.Context([], {}, summary, None, "cpu")
    assert manifest.reader("nccl_pct.mesh").read(ctx) is None
    if summary is None or summary.n_device_ops == 0:
        for name in DEVICE_READERS:
            assert manifest.reader(name).read(ctx) is None


@pytest.mark.parametrize("name", PROGRAM_READERS + ("nccl_pct.mesh",))
def test_the_program_readers_find_nothing_to_read(name, monkeypatch):
    """An empty recorder, and a program without one (the parent of the
    spans reads as the first): the reader gives nothing and raises
    nothing."""
    import sys

    import repro_torch
    from repro_torch import trace
    trace.reset()
    assert manifest.reader(name).read(None) is None
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert manifest.reader(name).read(None) is None

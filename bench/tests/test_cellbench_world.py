"""Whole runs of a cell over several ranks on the CPU (gloo), at a tiny
size, through :func:`bench.world.launch`: a tiny Kronecker configuration
with a mesh, on meshes (1, 2) and (2, 1).  The program comes out correct,
and the control and a fault in one rank's block do not; a rank that
raises or is killed ends the run with no result, within the group
timeout.  Each world is two processes."""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import manifest, world
from bench.tests.test_cellbench_run import M, tiny_cell

MESHES = {"1x2": [1, 2], "2x1": [2, 1]}
# 512 vertices: n_pad 768 on two model shards, so that each shard's K rows
# hold real vertices (at 128 the second shard's are all padding)
SCALE = 9
LIMIT_S = 240                 # a world here takes a few seconds


def mesh_cell(shape, *, system=world.SYSTEM, trace=False, seconds=0.5,
              cell="kron18.msbfs"):
    cfg, mix, e2e, layer = tiny_cell(cell)
    cfg = dict(cfg, scale=SCALE,
               mesh={"shape": list(shape), "axes": ["data", "model"]})
    return {"config": cfg, "mix": mix, "e2e": e2e, "layer": layer,
            "seed": 2**31 + 11, "seconds": seconds, "trace": trace,
            "device": "cpu", "system": system, "t0": world.monotonic()}


def launched(cell, directory):
    """-> (exit code, the result or None, rank 0's standard error, wall
    seconds)."""
    err = directory / "rank0.err"
    t = time.monotonic()
    with open(err, "w") as f:
        rc, out = world.launch(cell, limit_s=LIMIT_S, err=f,
                               env=dict(os.environ, OMP_NUM_THREADS="1"))
    wall = time.monotonic() - t
    lines = out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.read_text(), \
        wall


@pytest.fixture(scope="module", params=sorted(MESHES))
def program_world(request, tmp_path_factory):
    """The program over one mesh, run once for the tests of this module."""
    shape = MESHES[request.param]
    return (shape, *launched(mesh_cell(shape),
                             tmp_path_factory.mktemp(request.param)))


def test_program_is_correct_over_ranks(program_world):
    shape, rc, result, err, _ = program_world
    assert rc == 0, err[-3000:]
    assert result["correct"], result
    checks = result["checks"]
    assert checks["wrong_entries"]["value"] == 0
    assert checks["rows_compared"]["value"] >= 1
    assert result["attempted"] >= 1 and result["failed"] == 0
    e2e, _ = manifest.cell_metrics(M, "kron18.msbfs")
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert result["device"]["count"] == shape[0] * shape[1]
    assert list(result)[-1] == "checks"


def test_ranks_hold_identical_tuples(program_world):
    """Every rank holds rank 0's tuples: the configuration's own graph."""
    _, rc, _, err, _ = program_world
    assert rc == 0, err[-3000:]
    cfg = mesh_cell([1, 2])["config"]
    src, dst, _ = manifest.generator(cfg["generator"]).generate(
        cfg, cfg["graph_seed"], torch.device("cpu"))
    odd = torch.arange(src.numel()) * 2 + 1
    digest = int(((src * 1000003 + dst) * odd).sum())
    assert f"tuples {src.numel()}: the same on 2 ranks (digest {digest})" \
        in err


def test_peak_is_the_fullest_card(program_world):
    _, rc, result, err, _ = program_world
    assert rc == 0, err[-3000:]
    line = next(x for x in err.splitlines()
                if x.startswith("peak memory by rank: "))
    peaks = json.loads(line.split(": ", 1)[1].removesuffix(" B"))
    assert len(peaks) == 2
    assert result["device"]["memory_peak_bytes"] == max(peaks)
    assert result["metrics"]["peak_mem_gib"]["value"] == max(peaks) / 2**30


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("system", ["bench.systems:Control",
                                    "bench.tests.mesh_systems:ZeroBlock"],
                         ids=["control", "zeroed_block_on_rank_1"])
def test_not_correct_over_ranks(mesh, system, tmp_path):
    rc, result, err, _ = launched(mesh_cell(MESHES[mesh], system=system),
                                  tmp_path)
    assert rc == 0, err[-3000:]
    assert not result["correct"]
    assert result["checks"]["wrong_entries"]["value"] > 0


def test_traced_run_over_ranks(tmp_path):
    rc, result, err, _ = launched(mesh_cell([1, 2], trace=True), tmp_path)
    assert rc == 0, err[-3000:]
    assert result["correct"]
    assert {"sparse_sweep_pct.msbfs", "sweep_us.msbfs",
            "sweep_span_us.msbfs"} <= set(result["metrics"])
    assert result["metrics"]["sparse_sweep_pct.msbfs"]["value"] == 0.0
    assert result["device"]["window_s"] > 0
    assert "traced busy s by rank" in err


@pytest.mark.parametrize("system", ["RaiseInSetup", "KilledInWindow"])
def test_a_failing_rank_ends_the_run(system, tmp_path, capsys):
    rc, result, err, wall = launched(
        mesh_cell([1, 2], system=f"bench.tests.mesh_systems:{system}",
                  seconds=30), tmp_path)
    assert rc != 0 and result is None
    assert wall < world.GROUP_TIMEOUT_S + 30
    assert "rank 1 exited" in capsys.readouterr().err


def _ranks_under(directory) -> list:
    """Pids of the rank processes whose cell lies under ``directory``."""
    pids = []
    for proc in Path("/proc").iterdir():
        try:
            cmd = (proc / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if any(b"world.py" in c for c in cmd) and \
                any(str(directory).encode() in c for c in cmd):
            pids.append(int(proc.name))
    return pids


def test_ranks_end_when_the_launcher_is_killed(tmp_path):
    """A launcher killed outright (it cannot end its ranks) leaves no rank
    behind: each rank ends itself once its parent is gone."""
    cell = mesh_cell([1, 2], seconds=120)
    (tmp_path / "cell.json").write_text(json.dumps(cell))
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(world.ROOT)!r}, "
            f"{str(world.ROOT / 'src')!r}]\n"
            "from bench import world\n"
            f"world.launch(json.load(open({str(tmp_path / 'cell.json')!r})))"
            "\n")
    launcher = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        env=dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1"))
    try:
        deadline = time.monotonic() + 60
        while len(_ranks_under(tmp_path)) < 2:
            assert time.monotonic() < deadline, "the ranks never started"
            time.sleep(0.2)
    finally:
        launcher.kill()
        launcher.wait(timeout=30)
    deadline = time.monotonic() + 30
    while _ranks_under(tmp_path) and time.monotonic() < deadline:
        time.sleep(0.2)
    left = _ranks_under(tmp_path)
    for pid in left:
        os.kill(pid, signal.SIGKILL)
    assert not left


def test_a_cells_chips_are_its_mesh():
    cell = {"name": "kron18.msbfs-4", "config": "kron18", "chips": 4}
    mesh = {"shape": [1, 4], "axes": ["data", "model"]}
    assert manifest.layout(cell, {"mesh": mesh}) == mesh
    assert manifest.layout(dict(cell, chips=1), {}) is None
    with pytest.raises(ValueError, match="holds 2 cards"):
        manifest.layout(cell, {"mesh": dict(mesh, shape=[1, 2])})
    with pytest.raises(ValueError, match="names no mesh"):
        manifest.layout(cell, {})


@pytest.mark.parametrize("mesh", [
    {"shape": [1, 4]}, {"shape": [4], "axes": ["data", "model"]},
    {"shape": [2, 2], "axes": ["data", "data"]},
    {"shape": [1.0, 4], "axes": ["data", "model"]},
    {"shape": [1, 4], "axes": ["data", "model"], "devices": 4}])
def test_a_malformed_mesh_is_refused(mesh):
    cell = {"name": "kron18.msbfs-4", "config": "kron18", "chips": 4}
    with pytest.raises(ValueError, match="is not"):
        manifest.layout(cell, {"mesh": mesh})


def test_every_cell_has_its_layout():
    for w in M["workloads"]:
        mesh = manifest.layout(w, manifest.config(M, w["config"]))
        assert (mesh is None) == (w["chips"] == 1)


def test_the_control_tool_runs_a_mesh_cell_over_ranks(monkeypatch):
    """``bench/control.py`` sends a cell with a mesh through the launcher,
    one rank a card, and its control comes out not correct there."""
    from bench import control
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cell = mesh_cell([1, 2])
    result = control.control(
        cell["config"], cell["mix"], cell["e2e"], cell["layer"],
        seed=cell["seed"], seconds=cell["seconds"],
        mesh=cell["config"]["mesh"], device="cpu", limit_s=LIMIT_S)
    assert not result["correct"]
    assert result["checks"]["wrong_entries"]["value"] > 0
    assert result["device"]["count"] == 2


@pytest.mark.parametrize("chips", [1, 4])
def test_readers_take_every_card(chips, monkeypatch):
    """On several cards the roofline spreads the work's least time over
    them all and both shares read the cards' mean seconds, as
    ``device.busy_s`` and ``device.window_s`` do; on one card the mean is
    the card's own."""
    from types import SimpleNamespace

    from bench import readers, run, yardstick
    monkeypatch.setattr(yardstick, "call_bytes", lambda g, s: None)
    monkeypatch.setattr(yardstick, "least_seconds", lambda b, kind: 0.25)
    rank0 = SimpleNamespace(busy_s=2.0, window_s=4.0, n_device_ops=1)
    calls = [(0, SimpleNamespace(sources=None))] * 4
    busy = (1.0, 5.0) if chips > 1 else None
    ctx = run.Context(calls, {}, rank0, None, "H100", chips, busy)
    mean_busy, mean_window = busy or (2.0, 4.0)
    assert readers.roofline_pct(ctx) == 100.0 * 1.0 / chips / mean_busy
    assert readers.idle_pct(ctx) == 100.0 * (1 - mean_busy / mean_window)

"""Whole runs of the harness on the CPU at a tiny size: the program comes
out correct, and the control and each fault of the timed path come out
not correct.  The CPU stands in for the card only here: ``run.main``
refuses to run without one.  A cell whose configuration names a mesh
runs its configuration file, its scale cut, on that many gloo ranks
through :func:`bench.world.launch`, as ``bench/run.py`` runs it."""
import json
import os
import subprocess
import sys
import tempfile
import time

import pytest
import torch

from bench import manifest, run, systems, world

M = manifest.load()
TINY = {"kron18": {"scale": 7}, "rgg18": {"n": 300}, "kron20": {"scale": 11}}
SOURCES = {"msbfs1024": 24, "msbfs128": 16, "sssp": 1}   # a call
POOL = {"msbfs1024": 48, "msbfs128": 32, "sssp": 16, "serve_ic13": 48}
RATE = {"serve_ic13": 200}            # an open-loop mix's queries a second
MESH_LIMIT_S = 240


def tiny_cell(cell):
    w = manifest.workload(M, cell)
    cfg = dict(manifest.config(M, w["config"]), **TINY[w["config"]])
    traffic = w["traffic"]
    mix = dict(manifest.traffic(traffic), key_pool=POOL[traffic])
    if traffic in SOURCES:
        mix["sources_per_call"] = SOURCES[traffic]
    if traffic in RATE:
        mix["rate_per_s"] = RATE[traffic]
    e2e, layer = manifest.cell_metrics(M, cell)
    return cfg, mix, e2e, layer


def run_tiny(cell, *, trace=False, system=None, seconds=0.3, seed=2**31 + 3):
    cfg, mix, e2e, layer = tiny_cell(cell)
    if "mesh" in cfg:
        return run_mesh(cfg, mix, e2e, layer, trace=trace, system=system,
                        seconds=seconds, seed=seed)
    logs = []
    result, checks = run.run_cell(cfg, mix, e2e, layer, seed=seed,
                                  seconds=seconds, trace=trace, device="cpu",
                                  t0=time.perf_counter(), system=system,
                                  log=logs.append)
    return result, dict((name, v) for name, v, _, _ in checks)


def run_mesh(cfg, mix, e2e, layer, *, trace, system, seconds, seed):
    """The cell on one gloo rank a card of its mesh; ``system`` is a class
    built as ``(src, dst, n, device, mesh)``, by default the mesh's
    program."""
    spec = world.SYSTEM if system is None else \
        f"{system.__module__}:{system.__qualname__}"
    cell = {"config": cfg, "mix": mix, "e2e": e2e, "layer": layer,
            "seed": seed, "seconds": seconds, "trace": trace,
            "device": "cpu", "system": spec, "t0": world.monotonic()}
    with tempfile.TemporaryFile("w+") as err:
        rc, out = world.launch(cell, limit_s=MESH_LIMIT_S, err=err,
                               env=dict(os.environ, OMP_NUM_THREADS="1"))
        err.seek(0)
        assert rc == 0, err.read()[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    return result, {k: v["value"] for k, v in result["checks"].items()}


CELLS = [w["name"] for w in M["workloads"]]


def kind(cell):
    """``mesh``, or the query of the cell's mix."""
    w = manifest.workload(M, cell)
    if "mesh" in manifest.config(M, w["config"]):
        return "mesh"
    return manifest.traffic(w["traffic"])["query"]


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    result, checks = run_tiny(cell)
    assert result["correct"], result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert checks["wrong_entries"] == 0 and checks["rows_compared"] >= 1
    e2e, _ = manifest.cell_metrics(M, cell)
    assert set(result["metrics"]) == {m["name"] for m in e2e}
    assert list(result)[-1] == "checks"
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_counters(cell):
    result, _ = run_tiny(cell, trace=True)
    assert result["correct"]
    names = set(result["metrics"])
    expected = {"mesh": {"gather_mib.mesh", "sweep_span_us.mesh"},
                "apsp": {"sparse_sweep_pct.msbfs", "sweep_us.msbfs"},
                "sssp": {"level_us.sssp"},
                "serve": {"cache_hit_pct.serve", "tile_fill_pct.serve"}}
    assert expected[kind(cell)] <= names
    # no device on the CPU: the device readers find nothing to read
    assert not any("roofline" in n or "idle" in n for n in names)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result, checks = run_tiny(cell, system=systems.Control)
    assert not result["correct"]
    assert checks["wrong_entries"] > 0


def _wrap_run_batch(monkeypatch, change):
    from repro_torch.core import engine
    orig = engine._run_batch

    def broken(*args, **kw):
        return change(orig, *args, **kw)
    monkeypatch.setattr(engine, "_run_batch", broken)


def fault_state_unchanged(monkeypatch):
    """A sweep that returns its state unchanged."""
    from repro_torch.core import sweep
    orig = sweep.boolean_forms

    def forms(*args, **kw):
        return tuple((lambda f, d, p, step: (torch.zeros_like(f), d, p))
                     for _ in orig(*args, **kw))
    monkeypatch.setattr(sweep, "boolean_forms", forms)


def fault_half_batch(monkeypatch):
    """Half of each tile's sources left out (their rows padding)."""
    def change(orig, *args, **kw):
        args = list(args)
        args[6] = max(1, args[6] // 2)
        return orig(*args, **kw)
    _wrap_run_batch(monkeypatch, change)


def fault_answer_altered(monkeypatch):
    """One distance of every row altered where the engine produces it."""
    def change(orig, *args, **kw):
        st = orig(*args, **kw)
        d = st.dist.clone()
        d[:, 0] += 1
        return st._replace(dist=d)
    _wrap_run_batch(monkeypatch, change)


@pytest.mark.parametrize("fault", [fault_state_unchanged, fault_half_batch,
                                   fault_answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", ["kron18.msbfs", "rgg18.msbfs"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run_tiny(cell)
    assert not result["correct"]
    assert checks["wrong_entries"] > 0 and result["failed"] > 0


@pytest.mark.parametrize("fault", [fault_state_unchanged,
                                   fault_answer_altered],
                         ids=lambda f: f.__name__)
def test_sssp_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, _ = run_tiny("kron18.sssp")
    assert not result["correct"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_foreign_modules_compare_whole_names():
    assert run.foreign_modules(
        ["repro_torch", "repro_torch.api", "reprox", "jaxtyping", "numpy",
         "repro.core.engine", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]
    assert run.foreign_modules(["repro_torch.core", "bench.run"]) == []


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(run.ROOT)!r}, {str(run.ROOT / 'src')!r}]\n"
        "from bench import run, manifest\n"
        "from bench.tests.test_cellbench_run import run_tiny\n"
        "r, _ = run_tiny('kron18.msbfs', trace=True)\n"
        "assert r['correct']\n"
        "print(run.foreign_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(run.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_every_seed_deals_the_same_keys_in_its_own_order():
    from bench import driver
    degree = torch.ones(100, dtype=torch.int64)
    degree[:10] = 0
    mix = {"query": "apsp", "sources_per_call": 8, "key_pool": 32,
           "check_rows_per_call": 4}

    def rounds(seed, n=8):
        plan = driver.Plan(mix, degree, seed, pool_seed=0)
        return [plan.sources() for _ in range(n)]
    a, b, c = rounds(2**40 + 1), rounds(2**40 + 1), rounds(2**40 + 2)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not all((x == y).all() for x, y in zip(a, c))
    for calls in (a, c):
        for r in range(0, 8, 4):          # a round is 4 calls of 8 keys
            keys = sorted(int(k) for call in calls[r: r + 4] for k in call)
            assert len(set(keys)) == 32 and min(keys) >= 10
    assert sorted(int(k) for x in a[0:4] for k in x) == \
        sorted(int(k) for x in c[4:8] for k in x)
    with pytest.raises(ValueError):
        driver.Plan(dict(mix, key_pool=30), degree, 1, pool_seed=0)


@pytest.mark.parametrize("extra", [{"loop": "open"}, {"rate_per_s": 10}])
def test_a_mix_key_the_driver_does_not_read_is_refused(extra):
    from bench import driver
    mix = dict(manifest.traffic("msbfs128"), **extra)
    with pytest.raises(ValueError, match="unknown mix keys"):
        driver.Plan(mix, torch.ones(300, dtype=torch.int64), 1, pool_seed=0)


def test_kept_rows_are_on_the_host_and_the_call_timed_by_the_host_clock():
    import numpy as np
    from bench import driver
    out = torch.arange(24, dtype=torch.int32).view(4, 6)
    kept = driver.Kept(6, 1, torch.device("cpu"))
    kept.keep(0, out, np.array([1, 3]))
    assert kept.rows.device.type == "cpu"
    assert kept.where == [(0, 1), (0, 3)]
    assert torch.equal(kept.rows[:2], out[[1, 3]])
    timed = driver.timer(torch.device("cpu"))
    t0 = time.perf_counter()
    value, s = timed(lambda: time.sleep(0.05) or 7)
    assert value == 7 and 0.05 <= s <= time.perf_counter() - t0


def test_the_kept_rows_are_a_seeded_sample_of_every_drawn_row(monkeypatch):
    """More rows drawn than the buffer holds: it keeps a sample of them
    all, each slot the row it names, the same for the same seed, late
    calls as likely as early ones."""
    import numpy as np
    from bench import driver
    monkeypatch.setattr(driver, "KEPT_ROWS", 64)

    def sample(seed):
        kept = driver.Kept(5, seed, torch.device("cpu"))
        for call in range(400):
            out = torch.arange(call * 20, call * 20 + 20,
                               dtype=torch.int32).view(4, 5)
            kept.keep(call, out, np.array([0, 2]))
        return kept
    a, b, c = sample(7), sample(7), sample(8)
    assert a.cap == 64 and len(a.where) == 64 and a.seen == 800
    for slot, (call, row) in enumerate(a.where):
        assert a.rows[slot, 0] == call * 20 + row * 5
    assert a.where == b.where and a.where != c.where
    calls = np.array([call for call, _ in a.where + c.where])
    assert 0.3 < np.mean(calls >= 200) < 0.7

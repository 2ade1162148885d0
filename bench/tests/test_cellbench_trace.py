"""The readers of the program's spans and counters (``repro_torch.trace``,
and the serving tier's own counters) on whole runs of the harness on the
CPU at a tiny size: each returns a number in a traced run of the
program, and nothing under the control.  Which readers a cell has is
counted from the manifest."""
import pytest

from bench import manifest, systems
from bench.tests.test_cellbench_run import CELLS, M, kind, run_tiny

SPAN_METRICS = ("choose_us", "sweep_span_us", "tile_fill_pct", "load_s",
                "operand_build_s", "operand_gib", "gather_mib",
                "block_build_s", "cache_hit_pct")


def span_metrics(cell):
    return [m["name"] for m in manifest.cell_metrics(M, cell)[1]
            if m["name"].partition(".")[0] in SPAN_METRICS]


class Switching(systems.Program):
    """The program with the per-sweep form switch on, as the card's
    default path runs it (the CPU's default fixes one form a call)."""

    def __init__(self, src, dst, n, device):
        import repro_torch
        super().__init__(src, dst, n, device)
        self.handle = repro_torch.prepare(self.graph, device=device,
                                          dynamic=True)


@pytest.fixture(autouse=True)
def fresh_tables():
    from repro_torch import trace
    trace.reset()
    yield
    trace.reset()


@pytest.mark.parametrize("cell", CELLS)
def test_each_reader_finds_a_number_in_a_traced_run(cell):
    names = span_metrics(cell)
    assert names
    closed = kind(cell) in ("apsp", "sssp")
    result, _ = run_tiny(cell, trace=True,
                         system=Switching if closed else None)
    assert result["correct"]
    got = result["metrics"]
    assert set(names) <= set(got), sorted(set(names) - set(got))
    if kind(cell) == "mesh":
        assert got["gather_mib.mesh"]["value"] > 0
        assert got["block_build_s.mesh"]["value"] > 0
        assert got["sweep_span_us.mesh"]["value"] > 0
        return
    if kind(cell) == "serve":
        assert 0 < got["cache_hit_pct.serve"]["value"] < 100
        assert 0 < got["tile_fill_pct.serve"]["value"] <= 100
        assert got["sweep_span_us.serve"]["value"] > 0
        return
    outside = "level_us.sssp" if cell.endswith("sssp") else "sweep_us.msbfs"
    span = "sweep_span_us." + cell.rpartition(".")[2]
    assert 0 < got[span]["value"] <= got[outside]["value"]
    assert 0 < got[span.replace("sweep_span", "choose")]["value"] < \
        got[span]["value"]
    assert got["load_s"]["value"] > 0 and got["operand_build_s"]["value"] > 0
    assert 0 < got["operand_gib"]["value"] < 1
    if cell.endswith("sssp"):
        assert got["tile_fill_pct.sssp"]["value"] == 100 / 128


@pytest.mark.parametrize("cell", CELLS)
def test_no_reader_finds_a_number_under_the_control(cell):
    result, _ = run_tiny(cell, trace=True, system=systems.Control)
    assert not set(span_metrics(cell)) & set(result["metrics"])


@pytest.mark.parametrize("name", sorted({n for c in CELLS
                                         for n in span_metrics(c)}))
def test_a_program_without_the_recorder_gives_nothing(name, monkeypatch):
    """A checkout of the program from before the recorder: the reader
    finds nothing and raises nothing."""
    import sys

    import repro_torch
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert manifest.reader(name).read(None) is None

"""``BENCHMARK.json`` against the benchmark's contract, and every file a
cell needs found by name."""
import json

import pytest

from bench import driver, manifest, queries

M = manifest.load()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
CELLS = [w["name"] for w in M["workloads"]]


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_exactly_as_the_contract_has_them():
    assert set(M) == TOP
    for part, keys in KEYS.items():
        for e in M[part]:
            extra = set(e) - keys
            assert extra <= ({"workloads"} if part in ("end_to_end",
                                                       "per_layer")
                             else set()), (part, e["name"], extra)
            assert keys <= set(e), (part, e["name"])
    assert len(json.dumps(M)) < 64 * 1024


def test_names_units_and_lines():
    names = []
    for part in KEYS:
        for e in M[part]:
            assert manifest.NAME.fullmatch(e["name"]), e["name"]
            names.append((part, e["name"]))
    assert len(set(names)) == len(names)
    for m in M["end_to_end"] + M["per_layer"]:
        assert manifest.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert manifest.NAME.fullmatch(w["config"])
        assert manifest.NAME.fullmatch(w["traffic"])
        assert line(w["why"]) and w["chips"] in (1, 4)
    for c in M["configs"]:
        assert line(c["why"]) and line(c["source"])
        assert all(manifest.NAME.fullmatch(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in M["per_layer"]:
        assert line(m["layer"])
    assert all(line(w) for w in M["command"]) and len(M["command"]) <= 32


def test_limits():
    assert 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16
    assert 1 <= len(M["per_layer"]) <= 128
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in M["configs"]} == {w["config"]
                                                 for w in M["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    e2e, layer = manifest.cell_metrics(M, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in names, (cell, m["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", [])) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    w = manifest.workload(M, cell)
    entry = next(c for c in M["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith(M["paths"][0] + "/")
    cfg = manifest.config(M, w["config"])
    assert cfg["name"] == w["config"]
    assert hasattr(manifest.generator(cfg["generator"]), "generate")
    mix = manifest.traffic(w["traffic"])
    assert mix["query"] in driver.QUERIES or \
        queries.find(mix["query"]) is not None
    for m in manifest.cell_metrics(M, cell)[1]:
        assert callable(manifest.reader(m["name"]).read)


def test_config_files_are_distinct_and_list_their_cuts():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        cfg = manifest.config(M, c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]

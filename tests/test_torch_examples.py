"""The port's user examples (``examples/torch_*.py``) on the CPU.

Each runs as a subprocess with ``--device cpu`` and a timeout; all are
started at once, when the first test asks for one.  ``torch_quickstart``,
``torch_graph_analytics --scale 9`` and ``torch_resumable_job --ranks 8``
print the JAX scripts' lines, line for line: wall times are masked, and
a printed float may differ from JAX's by one unit in its last printed
digit (the centrality sums agree within rtol 1e-6, as in
``tests/test_torch_centrality.py``; rounding for print can flip that
digit).  The mesh examples run on gloo ranks: 8 for ``torch_resumable_job``
(the JAX script's (4, 2) -> (2, 2) path), 4 for ``torch_distributed_dawn``.
"""
import ast
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
TIMEOUT_S = 300
PORT = ("torch_quickstart", "torch_apsp_engine", "torch_graph_analytics",
        "torch_distributed_dawn", "torch_resumable_job")

# name -> (script, arguments, threads); the port's quickstart calibrates
# its sweep forms by wall clock at 128 sources on 5,120 nodes, three
# times: it gets the threads the others do not need
RUNS = {
    "port.quickstart": ("torch_quickstart.py", ["--device", "cpu"], 4),
    "jax.quickstart": ("quickstart.py", [], 1),
    "port.graph_analytics": ("torch_graph_analytics.py",
                             ["--device", "cpu", "--scale", "9"], 1),
    "jax.graph_analytics": ("graph_analytics.py", ["--scale", "9"], 1),
    "port.apsp_engine": ("torch_apsp_engine.py", ["--device", "cpu"], 1),
    "port.distributed_dawn": ("torch_distributed_dawn.py",
                              ["--device", "cpu", "--ranks", "4"], 1),
    "port.resumable_job": ("torch_resumable_job.py",
                           ["--device", "cpu", "--ranks", "8"], 1),
    "jax.resumable_job": ("resumable_job.py", [], 1),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Runs:
    """Every run of ``RUNS``, started together; ``out(name)`` waits for
    one and returns its standard output (it fails the test if the run
    failed or timed out)."""

    def __init__(self):
        self.procs, self.done = {}, {}
        for name, (script, args, threads) in RUNS.items():
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                       JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(threads))
            self.procs[name] = subprocess.Popen(
                [sys.executable, str(EXAMPLES / script), *args], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)

    def out(self, name: str) -> str:
        if name not in self.done:
            p = self.procs[name]
            try:
                out, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                self.done[name] = (None, f"timed out:\n{err[-3000:]}")
            else:
                self.done[name] = (out, None) if p.returncode == 0 else \
                    (None, f"exited {p.returncode}:\n{err[-3000:]}")
        out, why = self.done[name]
        assert out is not None, f"{name} {why}"
        return out

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def runs():
    r = _Runs()
    yield r
    r.close()


_TIME = re.compile(r"\d+\.\d+(?=s\b| ms\b)")
_FLOAT = re.compile(r"-?\d+\.\d+")


def _same_lines(port: str, jax: str) -> None:
    """Line for line, wall times masked; floats within one unit of their
    last printed digit."""
    a, b = port.splitlines(), jax.splitlines()
    assert len(a) == len(b), (a, b)
    for la, lb in zip(a, b):
        la, lb = _TIME.sub("<t>", la), _TIME.sub("<t>", lb)
        assert _FLOAT.sub("<f>", la) == _FLOAT.sub("<f>", lb), (la, lb)
        for x, y in zip(_FLOAT.findall(la), _FLOAT.findall(lb)):
            ulp = 10.0 ** -len(y.split(".")[1])
            assert abs(float(x) - float(y)) <= ulp * 1.001, (la, lb)


def test_quickstart_prints_the_jax_lines(runs):
    out = runs.out("port.quickstart")
    _same_lines(out, runs.out("jax.quickstart"))
    assert "matches scipy.sparse.csgraph ✓" in out


def test_graph_analytics_prints_the_jax_lines(runs):
    out = runs.out("port.graph_analytics")
    _same_lines(out, runs.out("jax.graph_analytics"))
    assert "centrality (128-source estimate)" in out


def test_resumable_job_on_eight_ranks_prints_the_jax_lines(runs):
    out = runs.out("port.resumable_job")
    _same_lines(out, runs.out("jax.resumable_job"))
    assert "resuming on survivor mesh {'data': 2, 'model': 2}" in out
    assert "reference run on 4x2 mesh" in out


def test_distributed_dawn_on_four_ranks(runs):
    out = runs.out("port.distributed_dawn").splitlines()
    tags = [line.split(":")[0].strip() for line in out[1:-1]]
    assert tags == ["single-device boolean (push)",
                    "single-device tropical (dense)",
                    "sharded boolean  mesh 4 data",
                    "sharded tropical mesh 4 data",
                    "sharded boolean  mesh 2x2 data/model",
                    "sharded tropical mesh 2x2 data/model"]
    assert out[0] == "graph: n=1024 m=12072, 32 sources"
    assert out[-1] == ("sharded distances bit-identical to the "
                       "single-device engines ✓")


def test_apsp_engine(runs):
    out = runs.out("port.apsp_engine").splitlines()
    assert out[0] == "graph: n=1024 m=3968 avg_deg=3.9 density=0.38%"
    assert out[2] == "graph diameter (max eccentricity): 62"
    assert out[-1] == ("insert (3, 200): hops 7 (cache) → 1 (sweep), "
                       "1 epoch invalidation")


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("name", PORT + ("_torch_world",))
def test_example_imports_neither_jax_nor_repro(name):
    found = _imports(EXAMPLES / f"{name}.py")
    assert not found & {"jax", "jaxlib", "repro"}, found


def _load(name: str):
    sys.path.insert(0, str(EXAMPLES))
    try:
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(EXAMPLES))
    return mod


@pytest.mark.parametrize("name", PORT)
def test_example_refuses_without_a_card(name):
    """``main`` runs on the card by default, with no silent fallback to
    the CPU; ``--device cpu`` is the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    mod = _load(name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])

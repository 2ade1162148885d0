"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file exposes plain C entry points (no PyTorch headers),
so one ``nvcc`` call per file takes seconds.  The shared library lands in
``build/repro_torch/`` at the repository root when the package runs from
a source checkout (``<root>/src/repro_torch``), else in a per-user cache
(``$XDG_CACHE_HOME/repro_torch``, by default ``~/.cache/repro_torch``).
It is named by a hash of its source and built on first use only: a
changed source gets a new name, so a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict


def build_dir(package: Path) -> Path:
    """Where the libraries of the package at ``package`` are built."""
    root = package.parents[1]
    if package.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


BUILD_DIR = build_dir(Path(__file__).resolve().parents[1])
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on first use and need the CUDA toolkit")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build(source: Path) -> Path:
    """Compile ``source`` into the build directory unless it is there."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library for ``source``, built on first use."""
    key = str(source)
    with _LOCK:
        if key not in _LOADED:
            _LOADED[key] = ctypes.CDLL(str(build(source)))
        return _LOADED[key]

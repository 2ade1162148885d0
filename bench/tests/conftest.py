"""Tests of the benchmark (``pytest bench/tests``).  The port's package
is imported from the checkout's ``src``."""
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

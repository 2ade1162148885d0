"""Seeded batch builders and the host-to-device pipeline (the port of
``repro/data``)."""
from . import tokens, graphs, pipeline

__all__ = ["graphs", "pipeline", "tokens"]

"""Deterministic synthetic LM token pipeline (the port's own copy of
``repro/data/tokens.py``: numpy, the same bytes).

Batches are a pure function of (seed, step) — byte-identical across hosts
and across elastic restarts (each host materializes only its shard of the
global batch; determinism is what makes skip-and-catchup straggler recovery
sound)."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def lm_batch(step: int, *, global_batch: int, seq_len: int, vocab: int,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens (not uniform noise: loss can decrease)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    base = rng.integers(0, vocab, size=(global_batch, 1))
    steps = rng.integers(1, 17, size=(global_batch, seq_len))
    toks = (base + np.cumsum(steps, axis=1)) % vocab
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    pad = seq_len - tokens.shape[1]
    if pad:
        tokens = np.pad(tokens, ((0, 0), (0, pad)))
        labels = np.pad(labels, ((0, 0), (0, pad)))
    return {"tokens": tokens[:, :seq_len], "labels": labels[:, :seq_len]}


def lm_iterator(*, global_batch: int, seq_len: int, vocab: int,
                seed: int = 0, start_step: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield lm_batch(step, global_batch=global_batch, seq_len=seq_len,
                       vocab=vocab, seed=seed)
        step += 1

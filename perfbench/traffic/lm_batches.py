"""Training batches: ``batch`` sequences of ``seq_len`` token ids a step,
uniform over the whole vocabulary, each step's rows drawn from
``(seed, step)`` (so every row of every step differs)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from perfbench.weights import rng as seeded

RUNNER = "train"


def batch(mix: Dict, vocab: int, seed: int, step: int) -> np.ndarray:
    return seeded(seed, 3, step).integers(
        0, vocab, size=(mix["batch"], mix["seq_len"]), dtype=np.int32)

"""Open-loop request traffic: Poisson arrivals at a fixed rate, lognormal
prompt and output lengths, token ids uniform over the whole vocabulary.

The mix's file gives the shape (``prompt_len`` and ``output_len``: median,
sigma, min, max; ``block``, see below; ``after_s``, the arrivals after the
window, which keep the load on while the window's requests finish); the
cell's file gives the rate (``rate_per_s``) and ``ramp_s``, the arrivals
before the window opens: long enough for the resident rows to reach
steady state, which takes longer the longer a request stays.

Every seed gets the same work in another order: each phase (ramp, window,
after) has ``round(rate * seconds)`` requests whose lengths are the
phase's quantiles of the two lognormals and whose gaps are the quantiles
of the exponential, the gaps scaled to fill the phase exactly. Each list
is cut into ``block`` strata of neighbouring quantiles, and every run of
``block`` consecutive requests takes one value from each stratum, drawn
and ordered by the seed. So every stretch of a few blocks is offered
about the same tokens at the same rate, whichever requests a window's
edges cut; the seed changes the order within the strata and blocks, and
the token ids.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List

import numpy as np

from perfbench.weights import rng as seeded

RUNNER = "serve"
PHASES = ("ramp", "window", "after")


def quantile_lengths(spec: Dict, n: int) -> np.ndarray:
    """The n quantiles of a lognormal of the given median and sigma,
    rounded and clipped to [min, max]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def quantile_gaps(n: int, seconds: float) -> np.ndarray:
    """n exponential quantile gaps scaled to sum to ``seconds``."""
    u = (np.arange(n) + 0.5) / n
    g = -np.log1p(-u)
    return g * (seconds / g.sum())


def stratified(values: np.ndarray, block: int, r) -> np.ndarray:
    """``values`` (sorted) reordered so that each run of ``block``
    consecutive entries holds one from each of ``block`` strata of
    neighbouring values, the choice in a stratum and the order in a block
    drawn from ``r``; a last, shorter run takes the rest."""
    strata = [r.permutation(s) for s in np.array_split(values, block)]
    out = []
    for b in range(len(strata[0])):
        run = [s[b] for s in strata if b < len(s)]
        out.extend(run[i] for i in r.permutation(len(run)))
    return np.array(out, dtype=values.dtype)


def ramp_s(mix: Dict, cell: Dict) -> float:
    return float(cell["ramp_s"])


def phase_seconds(mix: Dict, cell: Dict, seconds: float) -> Dict[str, float]:
    return {"ramp": ramp_s(mix, cell), "window": float(seconds),
            "after": float(mix["after_s"])}


def requests(mix: Dict, cell: Dict, vocab: int, seed: int,
             seconds: float) -> List[Dict]:
    """Every request of a run, in arrival order: ``due`` (seconds from
    the first arrival's phase start), ``phase``, ``prompt`` (int32 ids),
    ``max_new``."""
    rate = float(cell["rate_per_s"])
    out, t0 = [], 0.0
    for k, (phase, dur) in enumerate(phase_seconds(mix, cell, seconds).items()):
        n = max(1, int(round(rate * dur)))
        r, m = seeded(seed, 1, k), int(mix["block"])
        plens = stratified(quantile_lengths(mix["prompt_len"], n), m, r)
        olens = stratified(quantile_lengths(mix["output_len"], n), m, r)
        due = t0 + np.cumsum(stratified(quantile_gaps(n, dur), m, r))
        ids = seeded(seed, 2, k)
        for i in range(n):
            out.append({"due": float(due[i]), "phase": phase,
                        "prompt": ids.integers(0, vocab, size=int(plens[i]),
                                               dtype=np.int32),
                        "max_new": int(olens[i])})
        t0 += dur
    return out


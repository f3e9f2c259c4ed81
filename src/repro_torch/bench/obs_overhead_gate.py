"""Serve throughput with observability ON against OFF, gated to a budget.

The port of ``benchmarks/obs_overhead_gate.py``. ONE engine serves an
identical saturated decode workload with its ``Observability`` attached
and detached (``ServeEngine.set_obs`` at idle), repetitions INTERLEAVED
off/on, and each mode is scored by its BEST repetition: instrumentation
cost is work on every cycle, so it survives into the cleanest repetition,
while host contention does not.

Budget: ``REPRO_OBS_GATE_BUDGET`` (a fraction, default 0.02). The model is
the stablelm smoke config, as in the reference, on ``device`` (None means
CUDA).
"""
from __future__ import annotations

import os
import time
from typing import Iterator, Tuple

import numpy as np


def _run(eng, prompts, max_new: int) -> float:
    for k in eng.stats:
        eng.stats[k] = 0
    if eng.obs is not None:
        eng.obs.reset()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts]
    for r in reqs:
        eng.result(r, timeout=600.0)
    return time.perf_counter() - t0


def measure(quick: bool = False, device=None) -> dict:
    """Best-of tokens/sec with observability off and on, and their ratio
    (no budget check)."""
    from ..obs import Observability
    from ..serve.engine import ServeEngine
    from .serve_continuous import load_model

    cfg, params, dev = load_model("stablelm-1.6b", "smoke", device)
    chunk = 4
    n_req = 6
    max_new = 64 if quick else 128
    reps = 5 if quick else 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(n_req)]
    total_tokens = n_req * max_new
    obs = Observability()
    samples = {"off": [], "on": []}
    with ServeEngine(cfg, params, decode_chunk=chunk, max_batch=8,
                     kv_blocks=224, block_size=8, prefill_chunk=16,
                     max_seq_len=-(-(8 + max_new) // 8) * 8,
                     device=dev) as eng:
        _run(eng, prompts, max(2, chunk + 1))          # warm-up
        for _ in range(reps):
            for mode in ("off", "on"):
                eng.set_obs(obs if mode == "on" else None)
                samples[mode].append(total_tokens
                                     / _run(eng, prompts, max_new))
        eng.set_obs(None)
    off = float(np.max(samples["off"]))
    on = float(np.max(samples["on"]))
    return {"off": off, "on": on, "ratio": on / off, "reps": reps}


def bench(quick: bool = False, device=None
          ) -> Iterator[Tuple[str, str, str]]:
    budget = float(os.environ.get("REPRO_OBS_GATE_BUDGET", "0.02"))
    r = measure(quick, device)
    yield ("obs_gate_off_tok_per_s", f"{r['off']:.1f}",
           f"best_of_{r['reps']}")
    yield ("obs_gate_on_tok_per_s", f"{r['on']:.1f}",
           f"{r['ratio']:.3f}x_off")
    yield ("obs_gate_overhead_frac", f"{max(0.0, 1.0 - r['ratio']):.4f}",
           f"budget_{budget:.2f}")
    if r["ratio"] < 1.0 - budget:
        raise AssertionError(
            f"observability overhead gate failed: enabled path at "
            f"{r['on']:.1f} tok/s vs disabled {r['off']:.1f} tok/s "
            f"({(1.0 - r['ratio']) * 100:.1f}% > {budget * 100:.0f}% "
            "budget)")
    yield ("obs_gate", "ok", f"within_{budget * 100:.0f}pct")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it); 'cpu' runs "
                         "the plain versions")
    args = ap.parse_args()
    for name, val, derived in bench(quick=args.quick, device=args.device):
        print(f"{name},{val},{derived}")

"""Serve throughput with the request journal ON against OFF, gated to a
budget.

The port of ``benchmarks/journal_overhead_gate.py``. The journal
(:mod:`repro_torch.serve.journal`) appends one record per request
transition (submit, admit, first token, finish), never per token, so a
saturated decode workload should pay almost nothing for it. ONE engine
serves an identical workload with a journal attached (``fsync_every=0``:
buffered writes, fsync only at close, as a deployment amortizing
durability would run; fsync cost is the disk's, not the engine's) and
detached (``ServeEngine.set_journal`` at idle), repetitions INTERLEAVED
off/on. The reference scores each mode by its best of 5 repetitions (8
at full size); here the gate reads the MEDIAN of the per-pair on/off
ratios over REPS pairs: on a shared host the best of a few ~50 ms runs
moves by more than the budget between two identical modes, and a pair
run back to back shares the host's drift. The pairs alternate their order
(off/on, then on/off), so neither mode always runs second, and every
repetition starts from a resting engine: its futures are fulfilled before
its complete stage ends, so the next repetition would otherwise start
while the last one's pipeline still runs, and the journal would be
rebound, and closed, before that stage wrote its records. The tok/s rows
are each mode's median. Each repetition's six submits are one burst; its
prefill groups are kept beside its tokens/sec (a journaled submit's write
releases the GIL, and a burst admitted in more groups pays a prefill and
a cycle for each, which ``ServeEngine`` avoids by waiting for submits in
progress).

Budget: ``REPRO_JOURNAL_GATE_BUDGET`` (a fraction, default 0.05). The model
is the stablelm smoke config, as in the reference, on ``device`` (None
means CUDA).
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Iterator, Tuple

import numpy as np


#: off/on pairs, by ``quick``
REPS = {True: 160, False: 96}


def _rest(eng) -> None:
    """Wait until the engine's pipeline has no run in flight."""
    limit = time.perf_counter() + 60.0
    while eng._pipeline is not None and not eng._pipeline.idle():
        if time.perf_counter() > limit:
            raise RuntimeError("the engine did not come to rest in 60 s")
        time.sleep(0.001)


def _run(eng, prompts, max_new: int) -> float:
    for k in eng.stats:
        eng.stats[k] = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts]
    for r in reqs:
        eng.result(r, timeout=600.0)
    return time.perf_counter() - t0


def measure(quick: bool = False, device=None) -> dict:
    """Median tokens/sec with the journal off and on, the median of the
    per-pair on/off ratios, every repetition's tokens/sec and prefill
    groups by mode and the records the journaled repetitions wrote (no
    budget check)."""
    from ..serve.engine import ServeEngine
    from ..serve.journal import Journal
    from .serve_continuous import load_model

    cfg, params, dev = load_model("stablelm-1.6b", "smoke", device)
    chunk = 4
    n_req = 6
    max_new = 64 if quick else 128
    reps = REPS[bool(quick)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(n_req)]
    total_tokens = n_req * max_new
    samples = {"off": [], "on": []}
    groups = {"off": [], "on": []}
    journals = []
    with tempfile.TemporaryDirectory() as td, \
            ServeEngine(cfg, params, decode_chunk=chunk, max_batch=8,
                        kv_blocks=224, block_size=8, prefill_chunk=16,
                        max_seq_len=-(-(8 + max_new) // 8) * 8,
                        device=dev) as eng:
        _run(eng, prompts, max(2, chunk + 1))          # warm-up
        for i in range(reps):
            for mode in ("off", "on")[::1 if i % 2 == 0 else -1]:
                _rest(eng)
                journal = None
                if mode == "on":
                    journal = Journal(os.path.join(td, f"rep{i}.wal"),
                                      fsync_every=0)
                    journals.append(journal)
                eng.set_journal(journal)
                samples[mode].append(total_tokens
                                     / _run(eng, prompts, max_new))
                groups[mode].append(eng.stats["prefills"])
        _rest(eng)
        eng.set_journal(None)
    records = sum(j.records_written for j in journals)
    pairs = np.asarray(samples["on"]) / np.asarray(samples["off"])
    return {"off": float(np.median(samples["off"])),
            "on": float(np.median(samples["on"])),
            "ratio": float(np.median(pairs)), "reps": reps,
            "records": records, "samples": samples, "prefills": groups}


def rows(r: dict) -> Iterator[Tuple[str, str, str]]:
    """The reference's rows of a :func:`measure` result; raises
    AssertionError when the journaled path is over the budget."""
    budget = float(os.environ.get("REPRO_JOURNAL_GATE_BUDGET", "0.05"))
    yield ("journal_gate_off_tok_per_s", f"{r['off']:.1f}",
           f"median_of_{r['reps']}")
    yield ("journal_gate_on_tok_per_s", f"{r['on']:.1f}",
           f"{r['ratio']:.3f}x_off_median_of_pairs")
    yield ("journal_gate_overhead_frac", f"{max(0.0, 1.0 - r['ratio']):.4f}",
           f"budget_{budget:.2f}")
    if r["ratio"] < 1.0 - budget:
        raise AssertionError(
            f"journal overhead gate failed: journaled path at "
            f"{r['on']:.1f} tok/s vs plain {r['off']:.1f} tok/s "
            f"({(1.0 - r['ratio']) * 100:.1f}% > {budget * 100:.0f}% "
            "budget)")
    yield ("journal_gate", "ok", f"within_{budget * 100:.0f}pct")


def bench(quick: bool = False, device=None
          ) -> Iterator[Tuple[str, str, str]]:
    yield from rows(measure(quick, device))


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

"""Decode-overlap suite: the per-cycle dispatch / sync / bookkeeping split
of the synchronous against the async decode engine.

The port of ``benchmarks/decode_overlap_microbench.py``, with its row
names. The synchronous decode stage waits for every chunk's tokens and does
all grow / retire / admit bookkeeping while the device idles; the async
engine (``ServeEngine(async_decode=True)``) keeps the carry on the device
and dispatches chunk N+1 before it waits for chunk N, so the bookkeeping
overlaps the chunk. For each decode chunk size both engines serve one
saturated greedy workload (every prompt submitted up front), and each
``(chunk, mode)`` reports:

* tokens/s and the mean decode-cycle wall time;
* the cycle split read from the metrics registry (``engine.dispatch_s``,
  ``engine.chunk_sync_s``, ``engine.book_s``, reset in place between
  repetitions);
* the host gap: cycle time not covered by the chunk's device time. The
  device time is calibrated once per chunk size as the least sync-mode
  ``engine.chunk_s`` (copy + replay + wait) and shared by both modes, so
  ``gap = cycle_ms - device_ms`` and ``gap_frac = gap / cycle_ms`` put
  them on one footing.

The two modes run in turns (sync, async, sync, async, ...) and each is
summarised by its median, so drift of a shared host lands on both. Each
mode has its own engine per chunk size (the reference toggles one engine's
flag at idle; here the async carry lives on the device across runs and the
sync path rewrites it every chunk, so a mode is fixed at construction). On
CUDA both run the captured chunk. A final parity pass runs both modes in
fp32 compute on the paged ``gather`` oracle, chunked prefill included, and
fails unless their tokens are equal. On CUDA a regression guard fails the
suite when async loses its overlap at chunk <= 4 (a cycle over 1.05x
sync's); on the CPU every op finishes before the host goes on, so there is
no overlap to guard.

``arch``/``preset``/``device`` as in :mod:`repro_torch.bench.serve_continuous`
(smoke config by default, as the reference); ``trace_path`` writes the
async engine's last timed repetition's Chrome trace.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional, Tuple

import numpy as np


def _float(tree):
    """A copy of a param tree with every leaf in fp32."""
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()


def _run(eng, obs, prompts, max_new: int) -> Tuple[float, List]:
    """Submit every prompt up front (saturated batch), wait for all."""
    for k in eng.stats:
        eng.stats[k] = 0
    obs.reset()         # in place: the engine's cached handles survive
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new) for p in prompts]
    outs = [eng.result(r, timeout=600.0) for r in reqs]
    return time.perf_counter() - t0, outs


def bench(quick: bool = False, trace_path: Optional[str] = None,
          arch: str = "stablelm-1.6b", preset: str = "smoke", device=None
          ) -> Iterator[Tuple[str, str, str]]:
    from ..obs import Observability
    from ..serve.engine import ServeEngine
    from .serve_continuous import load_model

    cfg, params, dev = load_model(arch, preset, device)
    chunks = (2, 4, 8) if quick else (1, 2, 4, 8)
    n_req = 6 if quick else 8
    plen = 8
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32)
               for _ in range(n_req)]
    # enough decode cycles per run (~16) that async's fixed tax of one
    # extra cycle (the last sync, the one-late retirement) amortises
    cycles_target = 16 if quick else 24
    geo = dict(max_batch=8, kv_blocks=224, block_size=8, prefill_chunk=16)
    stage_times = None
    async_obs = None
    for chunk in chunks:
        max_new = cycles_target * chunk
        total = n_req * max_new
        geo["max_seq_len"] = -(-(plen + max_new) // 8) * 8
        engines = {}
        for mode in ("sync", "async"):
            obs = Observability()
            engines[mode] = (ServeEngine(
                cfg, params, decode_chunk=chunk, async_decode=mode == "async",
                obs=obs, device=dev, **geo), obs)
        try:
            for mode, (eng, obs) in engines.items():
                _run(eng, obs, prompts, max(2, chunk + 1))      # warm-up
            samples = {"sync": [], "async": []}
            for _ in range(3):
                for mode, (eng, obs) in engines.items():        # in turns
                    dt, _ = _run(eng, obs, prompts, max_new)
                    snap = obs.metrics.snapshot()
                    samples[mode].append({
                        "tok_per_s": total / dt,
                        "min_chunk_ms": 1e3 * snap["engine.chunk_s"]["min"],
                        "cycle_ms": 1e3 * snap["engine.cycle_s"]["mean"],
                        "disp_ms": 1e3 * snap["engine.dispatch_s"]["mean"],
                        "wait_ms":
                            1e3 * snap["engine.chunk_sync_s"]["mean"],
                        "book_ms": 1e3 * snap["engine.book_s"]["mean"],
                    })
            eng, async_obs = engines["async"]
            if eng._pipeline is not None:
                stage_times = eng._pipeline.stage_times
        finally:
            for eng, _ in engines.values():
                eng.close()
        res = {mode: {k: float(np.median([s[k] for s in runs]))
                      for k in runs[0]}
               for mode, runs in samples.items()}
        # the chunk's device time: the cleanest sync-cycle copy + replay +
        # wait bounds it from above; one constant for both modes
        c_ms = min(s["min_chunk_ms"] for s in samples["sync"]
                   if s["min_chunk_ms"] > 0)
        for mode in res:
            res[mode]["gap_ms"] = max(0.0, res[mode]["cycle_ms"] - c_ms)
            res[mode]["gap_frac"] = \
                res[mode]["gap_ms"] / max(res[mode]["cycle_ms"], 1e-9)
        s, a = res["sync"], res["async"]
        yield (f"overlap_c{chunk}_sync_tok_per_s", f"{s['tok_per_s']:.1f}",
               f"cycle_{s['cycle_ms']:.1f}ms")
        yield (f"overlap_c{chunk}_async_tok_per_s", f"{a['tok_per_s']:.1f}",
               f"{a['tok_per_s'] / s['tok_per_s']:.2f}x_sync")
        yield (f"overlap_c{chunk}_sync_cycle_ms", f"{s['cycle_ms']:.2f}",
               f"disp_{s['disp_ms']:.2f}_wait_{s['wait_ms']:.2f}"
               f"_book_{s['book_ms']:.2f}")
        yield (f"overlap_c{chunk}_async_cycle_ms", f"{a['cycle_ms']:.2f}",
               f"disp_{a['disp_ms']:.2f}_wait_{a['wait_ms']:.2f}"
               f"_book_{a['book_ms']:.2f}")
        yield (f"overlap_c{chunk}_sync_host_gap_frac",
               f"{s['gap_frac']:.3f}", f"gap_{s['gap_ms']:.2f}ms_per_cycle")
        yield (f"overlap_c{chunk}_async_host_gap_frac",
               f"{a['gap_frac']:.3f}",
               f"{a['gap_frac'] / max(s['gap_frac'], 1e-9):.2f}x_sync")
        if dev.type == "cuda" and chunk <= 4 \
                and a["cycle_ms"] > s["cycle_ms"] * 1.05:
            raise AssertionError(
                f"async decode lost its overlap at chunk={chunk}: "
                f"{a['cycle_ms']:.2f}ms/cycle vs sync {s['cycle_ms']:.2f}ms "
                f"(gap_frac {a['gap_frac']:.3f} vs {s['gap_frac']:.3f})")

    if stage_times is not None:
        yield ("overlap_async_stage_times_s",
               "|".join(f"{k}={v:.2f}" for k, v in stage_times.items()),
               "pipeline_stage_wall_time")
    if trace_path and async_obs is not None:
        async_obs.export(trace_path)
        yield ("overlap_trace_spans", str(len(async_obs.tracer)), trace_path)

    # parity in fp32 compute on the gather oracle, chunked prefill included
    # (one prompt longer than the 16-token window)
    pchunk = chunks[0]
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = _float(params)
    mixed = prompts[:2] + [rng.integers(1, cfg.vocab_size, size=24)
                           .astype(np.int32)]
    outs = {}
    for mode in (False, True):
        with ServeEngine(c32, p32, decode_chunk=pchunk, paged_impl="gather",
                         async_decode=mode, device=dev, **geo) as eng:
            outs[mode] = eng.generate(mixed, max_new=8)
    if not all(x.tolist() == y.tolist()
               for x, y in zip(outs[False], outs[True])):
        raise AssertionError("async decode diverged from the synchronous "
                             "engine on the gather oracle (fp32)")
    yield ("overlap_parity_gather", "ok", f"chunk_{pchunk}_3_prompts")


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the async engine's last timed repetition's "
                         "Chrome trace-event JSON here")
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--preset", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it); 'cpu' runs "
                         "the plain versions")
    args = ap.parse_args(argv)
    for name, val, derived in bench(args.quick, args.trace, args.arch,
                                    args.preset, args.device):
        print(f"{name},{val},{derived}", flush=True)


if __name__ == "__main__":
    main()

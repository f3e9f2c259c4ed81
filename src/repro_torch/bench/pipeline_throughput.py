"""Pipeline throughput (Pipeflow, arXiv:2202.00717 §5): scheduling tokens/sec
through the L-lines × S-stages task-parallel pipeline, vs the hand-rolled
sequential loop it replaces.

The port of ``benchmarks/pipeline_throughput.py`` on the port's
``pipeline``, ``data`` and engine, with the same row names.

Three panels:

* ``micro``    — synthetic fixed-work stages; lines × stages scaling of the
                 pipeline scheduler against a plain host loop running the
                 same stage bodies (derived column = pipeline/loop ratio);
* ``prefetch`` — the data layer's 2-stage prefetch pipeline in executor mode
                 vs the manual ``produce_one`` drive (batches/sec);
* ``serve``    — LM tokens/sec of the per-call grouped pipeline
                 (``ServeEngine._generate_grouped``: length groups flow
                 admit -> prefill -> decode -> complete, so one group's
                 prefill overlaps another's decode; stablelm-1.6b's smoke
                 config) vs a hand-rolled group-serial host loop over the
                 SAME programs (the engine's contiguous prefill and decode
                 chunk), as in the reference.

On a host with few cores the ratios measure *scheduling overhead*, not
parallel speedup (``bench.common.host_cores``); the lines×stages scaling
shape and the zero-dedicated-thread property are the point.
"""
from __future__ import annotations

import time

from ..core import HOST, Executor
from ..pipeline import Pipe, PipeType, Pipeline


def _spin(n: int) -> int:
    acc = 0
    for i in range(n):
        acc += i * i
    return acc


def _micro_rows(quick: bool):
    ntokens = 200 if quick else 2_000
    work = 200 if quick else 1_000
    S = 4
    kinds = [PipeType.SERIAL] + [PipeType.PARALLEL, PipeType.SERIAL,
                                 PipeType.PARALLEL][:S - 1]

    # hand-rolled loop baseline: same stage bodies, one host thread
    t0 = time.perf_counter()
    for _ in range(ntokens):
        for _s in range(S):
            _spin(work)
    loop_dt = time.perf_counter() - t0
    loop_rate = ntokens / loop_dt
    yield "pipeline_micro_loop_tok_per_s", f"{loop_rate:.1f}", "baseline"

    for L in ((1, 4) if quick else (1, 2, 4, 8)):
        ex = Executor(domains={HOST: 4})
        budget = ntokens

        def mk(s):
            def stage(pf):
                if s == 0 and pf.token >= budget:
                    pf.stop()
                    return
                _spin(work)
            return stage

        pl = Pipeline(L, *[Pipe(kinds[s], mk(s), name=f"s{s}")
                           for s in range(S)])
        t0 = time.perf_counter()
        pl.run(ex).wait()
        dt = time.perf_counter() - t0
        ex.shutdown(wait=False)
        rate = pl.num_tokens / dt
        yield (f"pipeline_micro_L{L}S{S}_tok_per_s", f"{rate:.1f}",
               f"{rate/loop_rate:.2f}x_loop_defer={pl.num_deferrals}")


def _prefetch_rows(quick: bool):
    from ..data.pipeline import DataConfig, Prefetcher, SyntheticLM
    cfg = DataConfig(vocab_size=512, seq_len=64 if quick else 256,
                     global_batch=4 if quick else 16, seed=0)
    nbatches = 20 if quick else 100

    src = SyntheticLM(cfg)
    p = Prefetcher(src.batch_at, depth=4)
    t0 = time.perf_counter()
    got = 0
    while got < nbatches:
        p.produce_one()
        p.get(timeout=30)
        got += 1
    manual_dt = time.perf_counter() - t0
    yield ("prefetch_manual_batch_per_s", f"{nbatches/manual_dt:.1f}",
           "baseline")

    ex = Executor(domains={HOST: 4})
    src = SyntheticLM(cfg)
    p = Prefetcher(src.batch_at, depth=4, executor=ex)
    t0 = time.perf_counter()
    p.start()
    for _ in range(nbatches):
        p.get(timeout=30)
    pipe_dt = time.perf_counter() - t0
    p.stop()
    ex.shutdown(wait=False)
    yield ("prefetch_pipeline_batch_per_s", f"{nbatches/pipe_dt:.1f}",
           f"{manual_dt/pipe_dt:.2f}x_manual")


def _serve_rows(quick: bool, device=None):
    import numpy as np
    import torch
    from ..configs import get_config
    from ..device import resolve_device
    from ..params import init_params
    from ..serve.engine import ServeEngine

    dev = resolve_device(device)
    cfg = get_config("stablelm-1.6b").smoke()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    max_new = 8 if quick else 32
    chunk = 4 if quick else 8
    rng = np.random.default_rng(0)
    lens = (8, 12) if quick else (16, 24, 32, 48)
    prompts = [rng.integers(0, cfg.vocab_size, size=s).astype(np.int32)
               for s in lens for _ in range(2)]
    total = len(prompts) * max_new

    with ServeEngine(cfg, params, decode_chunk=chunk, device=dev) as eng:
        # both arms run the SAME programs: the per-call grouped pipeline
        eng._generate_grouped(prompts, max_new)  # warm-up
        t0 = time.perf_counter()
        outs = eng._generate_grouped(prompts, max_new)
        pipe_dt = time.perf_counter() - t0

        # hand-rolled baseline: the pre-pipeline host loop, group-serial
        t0 = time.perf_counter()
        with torch.inference_mode():
            for s in lens:
                toks = np.stack([p for p in prompts if len(p) == s])
                key, cur = eng._prefill_contig(toks, s + max_new + 1)
                seqs = [cur[:, None].cpu()]
                remaining = max_new - 1
                while remaining > 0:
                    n = min(chunk, remaining)
                    seqs.append(eng._decode_n(key, n).cpu())
                    remaining -= n
                eng._drop_contig(key)
        loop_dt = time.perf_counter() - t0

    if any(o is None or len(o) != max_new for o in outs):
        raise RuntimeError("pipeline serve rows: a request returned no "
                           f"{max_new} tokens")
    yield "serve_loop_tok_per_s", f"{total/loop_dt:.1f}", "baseline"
    yield ("serve_pipeline_tok_per_s", f"{total/pipe_dt:.1f}",
           f"{loop_dt/pipe_dt:.2f}x_loop_{len(lens)}groups")


def bench(quick: bool = False, device=None):
    rows = list(_micro_rows(quick))
    rows.extend(_prefetch_rows(quick))
    rows.extend(_serve_rows(quick, device))
    return rows


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="seconds-scale smoke sizes")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it); 'cpu' runs "
                         "the plain path")
    args = ap.parse_args()
    for name, val, derived in bench(quick=args.quick, device=args.device):
        print(f"{name},{val},{derived}", flush=True)


if __name__ == "__main__":
    main()

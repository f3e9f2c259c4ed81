"""Serving launcher of the port: the resident continuous-batching engine.

Requests are submitted one by one against the long-running pipeline
(``submit()``/``result()``); with ``--stagger`` they arrive spaced out, so
later requests join the batch while earlier ones are mid-decode. Runs on
CUDA; without a CUDA device it raises unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --preset full \
        --batch 8 --prompt-len 128 --max-new 32 --stagger 0.05
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-moe-a2.7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-1.2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --trace /tmp/t.json --stats-interval 1
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --async-decode
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --deadline 0.5 --fault-inject 'alloc_fail:p=0.1,seed=1'

Attention archs, dense and MoE, page their KV (``--kv-blocks``,
``--block-size``, ``--prefill-chunk``); Mamba1 archs and the zamba2 hybrid
keep one state per batch slot (``--max-seq-len`` bounds prompt + new
tokens, and sizes zamba2's shared-block KV span per slot). Weights are
random, drawn from ``--seed`` (``torch.Generator``).

``--stats-interval`` prints a one-line runtime summary every N seconds and
``--trace`` writes a Chrome trace-event JSON of the run (Perfetto); each
turns observability on, as ``REPRO_OBS=1`` does. ``REPRO_PREFIX_CACHE=1``
turns the prefix cache on (paged archs). ``--async-decode`` runs the decode
loop one chunk ahead (``REPRO_ASYNC_DECODE``; ``--no-async-decode`` forces
the synchronous path with the variable set); greedy tokens are the same.

SLO overload control and faults: ``--priority`` and ``--deadline`` apply to
every submitted request, ``--tier-target TIER=SHARE`` (repeatable),
``--shed-budget``, ``--watchdog`` and ``--fault-inject`` configure the
engine (each unset one defers to its environment variable). A request that
fails typed (shed at submit, past its deadline, a failed row) is counted
and printed; the run goes on.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..obs import Observability, StatsLogger
from ..params import init_params
from ..serve.engine import ServeEngine
from ..serve.errors import ServeError


def main(argv=None):
    """Serve the prompts; returns each request's tokens (a numpy array
    apiece, in submission order; None for a request that failed typed)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help="model architecture of a family the port serves: "
                         "dense attention (e.g. stablelm-1.6b, qwen3-14b), "
                         "MoE (qwen2-moe-a2.7b, arctic-480b), Mamba1 SSM "
                         "(falcon-mamba-7b) or the Mamba2 hybrid "
                         "(zamba2-1.2b)")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per chunked-prefill window "
                         "(default: decode_chunk * block_size)")
    ap.add_argument("--kv-blocks", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="slot-state (SSM, hybrid) archs: cap on prompt "
                         "+ new tokens per request (default 512)")
    ap.add_argument("--stagger", type=float, default=0.0,
                    help="seconds between submissions (0 = all at once)")
    ap.add_argument("--async-decode", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="async decode lookahead: device-resident carry and "
                         "one chunk dispatched ahead. Unset defers to "
                         "REPRO_ASYNC_DECODE; --no-async-decode forces the "
                         "synchronous path even with the variable set")
    ap.add_argument("--priority", type=int, default=0,
                    help="scheduling tier of the submitted requests "
                         "(0 = highest/SLO tier; larger = best-effort)")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-request deadline in seconds (expired "
                         "requests fail typed DeadlineExceeded)")
    ap.add_argument("--tier-target", action="append", default=None,
                    metavar="TIER=SHARE",
                    help="guaranteed minimum admission share for a tier "
                         "under sustained higher-tier load (repeatable, "
                         "e.g. --tier-target 1=0.25)")
    ap.add_argument("--shed-budget", type=float, default=None, metavar="S",
                    help="load-shedding queue-wait budget (seconds, all "
                         "tiers): submit() raises Overloaded when the "
                         "estimated wait exceeds it. Unset defers to "
                         "REPRO_SHED_BUDGET_S")
    ap.add_argument("--watchdog", type=float, default=None, metavar="S",
                    help="engine watchdog budget: fail all futures typed "
                         "WatchdogTimeout when a busy engine makes no "
                         "progress for S seconds. Unset defers to "
                         "REPRO_WATCHDOG_S")
    ap.add_argument("--fault-inject", default=None, metavar="SPEC",
                    help="deterministic fault-injection spec (see "
                         "repro_torch.serve.faultinject), e.g. "
                         "'grow_fail:p=0.05,seed=11'. Unset defers to "
                         "REPRO_FAULT_INJECT")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--stats-interval", type=float, default=None,
                    help="print a one-line runtime stats summary every N "
                         "seconds (implies observability on)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON (Perfetto/"
                         "chrome://tracing) of the run (implies "
                         "observability on)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    gen = torch.Generator(dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               .astype(np.int32) for _ in range(args.batch)]
    total_new = args.batch * args.max_new

    if cfg.ssm:
        geom = dict(max_seq_len=args.max_seq_len)
    else:
        geom = dict(prefill_chunk=args.prefill_chunk,
                    kv_blocks=args.kv_blocks, block_size=args.block_size)
    obs = Observability() \
        if (args.stats_interval is not None or args.trace) else None
    logger = None
    if args.stats_interval is not None:
        logger = StatsLogger(obs.metrics, interval=args.stats_interval)
    tier_targets = None
    if args.tier_target:
        tier_targets = {}
        for spec in args.tier_target:
            tier, _, share = spec.partition("=")
            tier_targets[int(tier)] = float(share)
    with ServeEngine(cfg, params, decode_chunk=args.decode_chunk,
                     device=dev, obs=obs, async_decode=args.async_decode,
                     tier_targets=tier_targets,
                     shed_budget_s=args.shed_budget,
                     watchdog_s=args.watchdog,
                     fault_inject=args.fault_inject, **geom) as eng:
        if logger is not None:
            logger.start()
        t0 = time.time()
        reqs, failed = [], []
        for i, p in enumerate(prompts):
            try:
                reqs.append(eng.submit(p, max_new=args.max_new,
                                       priority=args.priority,
                                       deadline_s=args.deadline))
            except ServeError as e:          # shed at submit
                reqs.append(None)
                failed.append((i, e))
            if args.stagger:
                time.sleep(args.stagger)
        outs = []
        for i, r in enumerate(reqs):
            try:
                outs.append(eng.result(r, timeout=600.0)
                            if r is not None else None)
            except ServeError as e:          # expired, failed row, ...
                outs.append(None)
                failed.append((i, e))
        dt = time.time() - t0
        done = [o for o in outs if o is not None]
        gen = sum(len(o) for o in done)
        print(f"{cfg.name}: generated {gen} of {total_new} tokens in "
              f"{dt:.2f}s ({gen/dt:.1f} tok/s, batch={args.batch}, "
              f"device={dev}, mode=continuous, "
              f"async_decode={eng.async_decode})")
        print("engine stats:", eng.stats)
        for i, e in sorted(failed, key=lambda f: f[0]):
            print(f"request {i} failed: {type(e).__name__}: {e}")
        if done:
            print("sample:", done[0][:16].tolist())
        if logger is not None:
            logger.stop()
    if args.trace:
        obs.export(args.trace)
        print(f"trace written to {args.trace} "
              f"({len(obs.tracer)} spans; open at https://ui.perfetto.dev)")
    return outs


if __name__ == "__main__":
    main()

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


def main(argv=None):
    """Serve the prompts; returns each request's tokens (a numpy array
    apiece, in submission order)."""
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
    with ServeEngine(cfg, params, decode_chunk=args.decode_chunk,
                     device=dev, obs=obs, async_decode=args.async_decode,
                     **geom) as eng:
        if logger is not None:
            logger.start()
        t0 = time.time()
        reqs = []
        for p in prompts:
            reqs.append(eng.submit(p, max_new=args.max_new))
            if args.stagger:
                time.sleep(args.stagger)
        outs = [eng.result(r, timeout=600.0) for r in reqs]
        dt = time.time() - t0
        print(f"{cfg.name}: generated {total_new} tokens in {dt:.2f}s "
              f"({total_new/dt:.1f} tok/s, batch={args.batch}, "
              f"device={dev}, mode=continuous, "
              f"async_decode={eng.async_decode})")
        print("engine stats:", eng.stats)
        print("sample:", outs[0][:16].tolist())
        if logger is not None:
            logger.stop()
    if args.trace:
        obs.export(args.trace)
        print(f"trace written to {args.trace} "
              f"({len(obs.tracer)} spans; open at https://ui.perfetto.dev)")
    return outs


if __name__ == "__main__":
    main()

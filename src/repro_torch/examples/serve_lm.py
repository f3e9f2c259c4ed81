"""Continuous-batching serve demo on the port.

The port of ``examples/serve_lm.py``, on :class:`repro_torch.serve.engine.
ServeEngine`. One RESIDENT admit->prefill->decode->complete pipeline
serves every request for the life of the engine: ``submit()`` enqueues a
prompt and returns a future; the admit stage pulls groups from the queue
at chunk boundaries; decode advances ALL running sequences one chunk per
cycle (on CUDA one CUDA-graph replay, K1 reading the paged pool; window-0
prefill is K2); finished sequences retire individually without draining
the pipeline. While request A is mid-decode, request B's prefill runs in
the pipeline's prefill stage. Three demos, as in the reference: a burst,
mixed prompt lengths and a mid-stream join.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch qwen3-14b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu \
        --batch 4 --prompt-len 16 --max-new 8 --decode-chunk 4

Weights are random, drawn from a ``torch.Generator`` seeded 0, on the
arch's smoke config. Without ``--device`` it runs on CUDA and raises
without it.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine


def main(argv=None) -> dict:
    """Run the three demos; returns the burst's outputs, the mixed
    demo's stage-log kinds and the engine's final stats."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--decode-chunk", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    eng = ServeEngine(cfg, params, decode_chunk=args.decode_chunk,
                      record_stages=True, device=dev)
    try:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size,
                                size=args.prompt_len).astype(np.int32)
                   for _ in range(args.batch)]
        # warm-up: the prefill shapes of the admission group sizes the
        # timed bursts will form, and the kernels' first launches
        eng.generate(prompts[:1] * len(prompts),
                     max_new=args.decode_chunk + 1)

        # one burst through the resident pipeline (generate() is
        # submit-all + gather: the compatibility shim over the queue)
        t0 = time.time()
        outs = eng.generate(prompts, max_new=args.max_new)
        dt = time.time() - t0
        total = args.batch * args.max_new
        print(f"{cfg.name}: {total} tokens in {dt:.2f}s "
              f"({total/dt:.1f} tok/s) via the resident pipeline "
              f"({eng.stats['decode_cycles']} chunked decode launches) "
              f"on {dev}")
        print("first sample:", outs[0][:24].tolist())

        # mixed prompt lengths: chunked prefill makes per-window shapes
        # uniform, so DIFFERENT lengths ride one admission group / one
        # prefill launch and share the decode batch
        mixed = prompts[: args.batch // 2] + [
            rng.integers(0, cfg.vocab_size,
                         size=args.prompt_len // 2).astype(np.int32)
            for _ in range(args.batch - args.batch // 2)]
        before = dict(eng.stats)      # stats are engine-lifetime cumulative
        n_events = len(eng.stage_log)
        t0 = time.time()
        eng.generate(mixed, max_new=args.max_new)
        kinds = [s for s, _, _, _ in eng.stage_log[n_events:]]
        print(f"mixed-length ({args.prompt_len} and "
              f"{args.prompt_len // 2}): {total} tokens in "
              f"{time.time()-t0:.2f}s; "
              f"{eng.stats['admitted'] - before['admitted']} admissions over "
              f"{eng.stats['prefills'] - before['prefills']} prefill "
              f"launches, {eng.stats['retired'] - before['retired']} "
              f"individual retirements, {kinds.count('pump')} pump cycles")

        # mid-stream submission: A decodes for a while, B joins halfway
        a = eng.submit(prompts[0], max_new=args.max_new)
        time.sleep(0.05)
        b = eng.submit(prompts[1][: args.prompt_len // 2], max_new=8)
        ra, rb = eng.result(a), eng.result(b)
        print(f"mid-stream join: A got {ra.shape[0]} tokens, B got "
              f"{rb.shape[0]} tokens from the same pipeline run "
              f"(admit parks: {eng.stats['admit_parks']})")
        return {"burst": outs, "mixed_kinds": kinds, "join": (ra, rb),
                "stats": dict(eng.stats)}
    finally:
        eng.close()


if __name__ == "__main__":
    main()

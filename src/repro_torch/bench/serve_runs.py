"""Repeat ``chip_smoke.py``'s serve workload and account for its TTFT.

Full-width stablelm-1.6b (default), qwen2-moe-a2.7b (``--arch``; the
same paged pool), falcon-mamba-7b or zamba2-1.2b (``--arch``; the
slot-state pool), random bf16 weights from a seeded generator,
``ServeEngine(decode_chunk=8, max_batch=8, kv_blocks=128, block_size=16)``
(the pool geometry applies to the paged arch only), 8 requests with
prompts of 16 to 300 tokens submitted 20 ms apart. Each of
``--runs`` runs builds a fresh engine with ``record_stages=True``, serves a
warm-up request, then the 8 requests, and prints:

* output tok/s and TTFT p50/max (the end-to-end numbers of the smoke run);
* per request: queue wait (submit -> admit) and admit -> first token;
* the cycle timeline from the engine's stage log, in ms from the first
  submit: when each cycle admitted (and whom), ran its window-0 prefill,
  finished its decode stage (with the decode chunk's own seconds) and
  completed.

The last line is a JSON summary with the per-run numbers and their spread.

    PYTHONPATH=src python -m repro_torch.bench.serve_runs [--runs 3]
        [--max-new 32]
        [--arch qwen2-moe-a2.7b | falcon-mamba-7b | zamba2-1.2b]

Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..configs import get_config
from ..params import init_params
from ..serve.engine import ServeEngine

PROMPT_LENS = (16, 24, 32, 57, 90, 128, 200, 300)


def _one_run(cfg, params, prompts, max_new: int, dev):
    eng = ServeEngine(cfg, params, decode_chunk=8, max_batch=8,
                      kv_blocks=128, block_size=16, record_stages=True,
                      device=dev)
    try:
        eng.result(eng.submit(prompts[0][:8], max_new=2))
        torch.cuda.synchronize()
        n_warm = len(eng.stage_log)
        t0 = time.perf_counter()
        reqs = []
        for p in prompts:
            reqs.append(eng.submit(p, max_new=max_new))
            time.sleep(0.02)
        outs = [eng.result(r, timeout=600.0) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log = eng.stage_log[n_warm:]
    finally:
        eng.close()
    assert all(o.shape == (max_new,) for o in outs)
    ttft = sorted(r.ttft for r in reqs)
    run = {"wall_s": wall, "tok_s": len(prompts) * max_new / wall,
           "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
           "requests": [{"prompt": r.prompt_len,
                         "queue_ms": (r.admitted_at - r.submitted_at) * 1e3,
                         "admit_to_first_ms":
                             (r.first_token_at - r.admitted_at) * 1e3}
                        for r in reqs]}
    cycles: dict = {}
    for stage, token, info, t in log:
        c = cycles.setdefault(token, {})
        ms = round((t - t0) * 1e3, 1)
        if stage == "decode":
            c["decode_end_ms"] = ms
            c["chunk_ms"] = round(info[1] * 1e3, 1) if info else 0.0
        elif stage in ("admit", "prefill"):
            c[stage + "_ms"] = ms
            c["rows"] = info
        elif stage in ("pump", "complete", "prefill_chunk"):
            c[stage + "_ms"] = ms
    run["cycles"] = [dict(token=k, **v) for k, v in sorted(cycles.items())]
    return run


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=["stablelm-1.6b", "qwen2-moe-a2.7b",
                             "falcon-mamba-7b", "zamba2-1.2b"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_runs needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    cfg = get_config(args.arch)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPT_LENS]
    runs = []
    for i in range(args.runs):
        run = _one_run(cfg, params, prompts, args.max_new, dev)
        runs.append(run)
        print(f"[run {i}] max_new {args.max_new}: {run['tok_s']:.1f} tok/s"
              f" in {run['wall_s']:.3f}s | TTFT p50 {run['ttft_p50_s']:.4f}s"
              f" max {run['ttft_max_s']:.4f}s", flush=True)
        for r in run["requests"]:
            print(f"    prompt {r['prompt']:4d}: queue {r['queue_ms']:8.1f}"
                  f" ms | admit->first {r['admit_to_first_ms']:8.1f} ms",
                  flush=True)
        for c in run["cycles"]:
            print(f"    cycle {c}", flush=True)
    tps = [r["tok_s"] for r in runs]
    p50 = [r["ttft_p50_s"] for r in runs]
    print(json.dumps({"card": smi, "arch": cfg.name, "max_new": args.max_new,
                      "tok_s": tps, "tok_s_min": min(tps),
                      "tok_s_max": max(tps), "ttft_p50_s": p50,
                      "runs": runs}))


if __name__ == "__main__":
    main()

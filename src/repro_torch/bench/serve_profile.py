"""Where a decode step's time goes on the GPU (full-width stablelm-1.6b).

Seeds a paged pool with 8 rows at the chip smoke run's prompt lengths
(prefilled through the port's own ``prefill``), then, for each paged read
path (``kernel`` = K1, ``loop`` = the plain page loop, ``gather`` = the
materializing oracle):

* times ``decode_chunk_paged`` over 8 steps with the host clock around a
  device sync (wall ms per step, the engine's real cost);
* traces one chunk with ``torch.profiler`` and reports the device busy time
  (sum of GPU kernel time), the idle share of the wall time, the kernel
  launches per step and the top kernels by device time.

Window-0 prefill (4 x 128 tokens) is timed the same way with ``flash``
(K2) and ``chunked`` (the plain path).

    PYTHONPATH=src python -m repro_torch.bench.serve_profile

Needs one CUDA device; writes nothing but stdout (the last line is a JSON
summary).
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import lm
from ..params import init_params
from ..serve.kvcache import init_kv_pool, scatter_prefill_row

PROMPT_LENS = (16, 24, 32, 57, 90, 128, 200, 300)
STEPS = 8


def _wall_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _profile(fn):
    """(device busy ms, kernel launches, top kernels) of one call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0 and getattr(e, "device_type", None) \
                == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    return busy, launches, rows[:8]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    cfg = get_config("stablelm-1.6b")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    bs, nblk = 16, 128
    B = len(PROMPT_LENS)
    mb = 32
    rng = np.random.default_rng(0)
    pool = init_kv_pool(cfg, nblk, bs, dev)
    tables = np.zeros((B, mb), np.int32)
    nxt = 1
    summary = {"card": smi, "decode": {}, "prefill": {}}
    with torch.inference_mode():
        for b, n in enumerate(PROMPT_LENS):
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
            _, cache = lm.prefill(cfg, params, toks)
            need = (n + STEPS * 4) // bs + 1
            ids = list(range(nxt, nxt + need))
            nxt += need
            tables[b, :need] = ids
            scatter_prefill_row(pool, torch.tensor(ids[:-(-n // bs)],
                                                   device=dev),
                                cache["k"][:, 0], cache["v"][:, 0])
        tables_d = torch.from_numpy(tables).to(dev)
        lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device=dev)
        last = torch.zeros(B, dtype=torch.int32, device=dev)
        rem = torch.full((B,), 1 << 20, dtype=torch.int32, device=dev)
        layers = lm.layer_views(params)          # built once, as the engine
        for impl in ("kernel", "loop", "gather"):
            def chunk():
                lm.decode_chunk_paged(cfg, params, pool, tables_d,
                                      (lengths, last, rem), STEPS,
                                      impl=impl, layers=layers)
            wall = _wall_ms(chunk) / STEPS
            busy, launches, top = _profile(chunk)
            busy /= STEPS
            summary["decode"][impl] = {
                "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
                "idle_share": 1.0 - busy / wall,
                "launches_per_step": launches / STEPS,
                "top": [(k, ms / STEPS, c // STEPS) for k, ms, c in top]}
            print(f"[decode:{impl}] B={B} wall {wall:.3f} ms/step | device "
                  f"busy {busy:.3f} ms/step | idle {1 - busy / wall:.1%} | "
                  f"{launches / STEPS:.0f} launches/step", flush=True)
            for k, ms, c in top:
                print(f"    {ms / STEPS:8.4f} ms/step  x{c // STEPS:<5d} "
                      f"{k[:90]}", flush=True)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 128)).astype(np.int32)).to(dev)
        for impl in ("flash", "chunked"):
            def pre():
                lm.prefill(cfg, params, toks, impl=impl)
            wall = _wall_ms(pre)
            busy, launches, top = _profile(pre)
            summary["prefill"][impl] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": 1.0 - busy / wall, "launches": launches,
                "top": top}
            print(f"[prefill:{impl}] 4x128 wall {wall:.3f} ms | device busy"
                  f" {busy:.3f} ms | idle {1 - busy / wall:.1%} | "
                  f"{launches} launches", flush=True)
            for k, ms, c in top[:5]:
                print(f"    {ms:8.4f} ms  x{c:<5d} {k[:90]}", flush=True)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

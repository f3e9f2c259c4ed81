"""Where a decode step's time goes on the GPU, at full width.

``--arch stablelm-1.6b`` (default; the paged path):

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
(K2) and ``chunked`` (the plain path). ``--arch qwen2-moe-a2.7b`` (60
experts top-4 plus shared experts in each layer's FFN) takes the same
paged path.

``--arch falcon-mamba-7b`` or ``zamba2-1.2b`` (the slot-state path): the
8 rows' states are prefilled at B=1 and copied into an 8-slot
:func:`repro_torch.models.lm.init_cache` pool (zamba2: KV spans of the
engine's default ``max_seq_len``, 512), as the engine does; then
``decode_chunk_slots`` is timed and traced the same way (one decode step
has no kernel of the port: it is GEMVs and elementwise ops, and zamba2's
shared-block decode attention is plain torch, as in the reference), and
one 300-token prefill with each path: falcon-mamba's ``kernel`` (K3) and
``plain`` scans, zamba2's ``flash`` (K2) and ``chunked`` shared-block
attention.

    PYTHONPATH=src python -m repro_torch.bench.serve_profile
    PYTHONPATH=src python -m repro_torch.bench.serve_profile \
        --arch qwen2-moe-a2.7b
    PYTHONPATH=src python -m repro_torch.bench.serve_profile \
        --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.bench.serve_profile \
        --arch zamba2-1.2b

Needs one CUDA device; writes nothing but stdout (the last line is a JSON
summary).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..configs import get_config
from ..models import lm
from ..params import init_params
from ..serve.engine import write_slot_state
from ..serve.kvcache import init_kv_pool, scatter_prefill_row

PROMPT_LENS = (16, 24, 32, 57, 90, 128, 200, 300)
STEPS = 8
#: the slot pool's KV span per row (zamba2): the engine's default
MAX_SEQ = 512


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


def _report(summary, kind, name, fn, steps: int = 1) -> None:
    """Time ``fn`` (``steps`` model steps) on the host clock and trace it:
    wall and device-busy ms per step, idle share, launches per step, top
    kernels."""
    wall = _wall_ms(fn) / steps
    busy, launches, top = _profile(fn)
    busy /= steps
    summary[kind][name] = {
        "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy / wall, "launches_per_step": launches / steps,
        "top": [(k, ms / steps, c // steps) for k, ms, c in top]}
    print(f"[{kind}:{name}] wall {wall:.3f} ms/step | device busy "
          f"{busy:.3f} ms/step | idle {1 - busy / wall:.1%} | "
          f"{launches / steps:.0f} launches/step", flush=True)
    for k, ms, c in top[:6]:
        print(f"    {ms / steps:8.4f} ms/step  x{c // steps:<5d} {k[:90]}",
              flush=True)


def _slot_path(cfg, params, dev, rng, summary) -> None:
    """falcon-mamba or zamba2: one decode step over an 8-slot state pool,
    and one 300-token prefill with each path."""
    B = len(PROMPT_LENS)
    state = {k: v for k, v in lm.init_cache(cfg, B, MAX_SEQ,
                                            device=dev).items()
             if k != "pos"}
    layers = lm.layer_views(params)
    with torch.inference_mode():
        for b, n in enumerate(PROMPT_LENS):
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, n)).astype(np.int32)).to(dev)
            _, cache = lm.prefill(cfg, params, toks, layers=layers)
            write_slot_state(state, b, cache, n)
        lengths = torch.tensor(PROMPT_LENS, dtype=torch.int32, device=dev)
        last = torch.zeros(B, dtype=torch.int32, device=dev)
        rem = torch.full((B,), 1 << 20, dtype=torch.int32, device=dev)

        def chunk():
            lm.decode_chunk_slots(cfg, params, state, (lengths, last, rem),
                                  STEPS, layers=layers)
        _report(summary, "decode", "slots", chunk, STEPS)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, PROMPT_LENS[-1])).astype(np.int32)
            ).to(dev)
        impls = ("flash", "chunked") if cfg.hybrid_attn_every \
            else ("kernel", "plain")
        for impl in impls:
            def pre():
                lm.prefill(cfg, params, toks, impl=impl, layers=layers)
            _report(summary, "prefill", impl, pre)


def main(argv=None) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("serve_profile needs a CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=["stablelm-1.6b", "qwen2-moe-a2.7b",
                             "falcon-mamba-7b", "zamba2-1.2b"])
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    cfg = get_config(args.arch)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    rng = np.random.default_rng(0)
    summary = {"card": smi, "arch": cfg.name, "decode": {}, "prefill": {}}
    if cfg.ssm:
        _slot_path(cfg, params, dev, rng, summary)
        print(json.dumps(summary))
        return
    bs, nblk = 16, 128
    B = len(PROMPT_LENS)
    mb = 32
    pool = init_kv_pool(cfg, nblk, bs, dev)
    tables = np.zeros((B, mb), np.int32)
    nxt = 1
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
            _report(summary, "decode", impl, chunk, STEPS)
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 128)).astype(np.int32)).to(dev)
        for impl in ("flash", "chunked"):
            def pre():
                lm.prefill(cfg, params, toks, impl=impl)
            _report(summary, "prefill", impl, pre)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

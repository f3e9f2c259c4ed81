"""Paged decode-attention read path across pool occupancies.

The port of ``benchmarks/paged_decode_microbench.py`` (a decode-step
microbench, not a paper figure). The gather oracle pays O(capacity) per row
per step — it materializes and attends over ``max_blocks * block_size``
positions whatever the rows' true lengths; the paged paths bound their work
by the rows' lengths, so their cost follows *occupancy*.

On the card the shapes are stablelm-1.6b's full-width heads: H = KV = 32,
hd = 64, bf16, block 16, 64 pages a row, B = 8 (the reference used a
smaller H = 8, KV = 4 in fp32). Rows:

* ``paged_read_{low,mid,full}_occ_ms`` — K1 (``kernels/csrc/
  paged_attention.cu``), the port's serve default on the card, at one page,
  half and all 64 pages a row; the derived column is its speedup over the
  gather oracle;
* ``plain_read_*`` — K1's plain version, the page loop of
  :func:`repro_torch.kernels.ref.paged_attention_ref`;
* ``gather_read_*`` — the gather oracle,
  :func:`repro_torch.serve.kvcache.gather_read_attention`;
* ``decode_step_{paged,gather}_low_occ_ms`` — the whole 24-layer
  ``lm.decode_step_paged`` at full width (seeded random bf16 weights) with
  K1 and with the gather oracle, rows at one page;
* ``paged_read_kernel_launches`` — K1's launches in this suite.

The reference's ``pallas_interpret_read_low_occ_ms`` (the Pallas kernel in
the interpreter) has no counterpart: a CUDA kernel has no interpret mode.
With ``device="cpu"`` (the tests) the suite runs stablelm's smoke config
with 16 pages a row, and ``paged_read_*`` is K1's plain version.
"""
from __future__ import annotations

import time
from typing import Iterator, Tuple

import torch

from ..device import resolve_device


def _time_ms(fn, iters: int, dev) -> float:
    fn()                                         # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize(dev)
        return s.elapsed_time(e) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def bench(quick: bool = False, device=None) -> Iterator[Tuple[str, str, str]]:
    from ..configs import get_config
    from ..kernels import ops
    from ..kernels.ref import paged_attention_ref
    from ..models import lm
    from ..params import init_params
    from ..serve.kvcache import gather_read_attention

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg = get_config("stablelm-1.6b")
    if not cuda:
        cfg = cfg.smoke()
    B, H, KV, hd = 8, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    bs = 16
    mb = 64 if cuda else 16                      # capacity per row
    iters = (20 if quick else 100) if cuda else 3
    N = B * mb + 1
    cap = mb * bs
    dt = torch.bfloat16

    g = torch.Generator(dev).manual_seed(0)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(dt)
    pool_kv = torch.randn((2, N, KV, bs, hd), generator=g,
                          device=dev).to(dt)
    tables = (1 + torch.arange(B * mb, dtype=torch.int32,
                               device=dev)).reshape(B, mb)
    k1_before = ops.launch_counts()["paged_attention"]

    for occ_name, pos in (("low", bs - 1), ("mid", cap // 2 - 1),
                          ("full", cap - 1)):
        lengths = torch.full((B,), pos, dtype=torch.int32, device=dev)
        t_paged = _time_ms(lambda: ops.paged_attention(
            q, pool_kv, tables, lengths, impl="kernel"), iters, dev)
        t_plain = _time_ms(lambda: paged_attention_ref(
            q, pool_kv, tables, lengths), max(2, iters // 10), dev)
        t_gather = _time_ms(lambda: gather_read_attention(
            q, pool_kv, tables, lengths), iters, dev)
        yield (f"paged_read_{occ_name}_occ_ms", f"{t_paged:.5f}",
               f"{t_gather / t_paged:.2f}x_gather")
        yield (f"plain_read_{occ_name}_occ_ms", f"{t_plain:.5f}",
               "plain page loop")
        yield (f"gather_read_{occ_name}_occ_ms", f"{t_gather:.5f}", "")

    # the whole decode step at low occupancy (all layers, full width)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0),
                         device=dev)
    layers = lm.layer_views(params)
    mb2 = 32                            # large pool: the short rows below
    #                                     sit at ~3% of per-row capacity
    N2 = B * mb2 + 1
    pool = torch.zeros((cfg.num_layers, 2, N2, KV, bs, hd), dtype=dt,
                       device=dev)
    tables2 = (1 + torch.arange(B * mb2, dtype=torch.int32,
                                device=dev)).reshape(B, mb2)
    lengths2 = torch.full((B,), bs - 1, dtype=torch.int32, device=dev)
    token = torch.ones((B,), dtype=torch.int32, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    times = {}
    for impl in ("kernel", "gather"):
        times[impl] = _time_ms(
            lambda: lm.decode_step_paged(cfg, params, pool, tables2,
                                         lengths2, token, active, impl=impl,
                                         layers=layers)[0],
            max(3, iters // 4), dev)
    yield ("decode_step_paged_low_occ_ms", f"{times['kernel']:.4f}",
           f"{times['gather'] / times['kernel']:.2f}x_gather")
    yield ("decode_step_gather_low_occ_ms", f"{times['gather']:.4f}", "")
    yield ("paged_read_kernel_launches",
           str(ops.launch_counts()["paged_attention"] - k1_before),
           "K1 launches in this suite" if cuda else "0: the plain version "
           "on the CPU")


if __name__ == "__main__":
    for name, val, derived in bench(quick=True):
        print(f"{name},{val},{derived}")

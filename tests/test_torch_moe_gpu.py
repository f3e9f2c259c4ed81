"""The MoE serving path on the card (qwen2-moe and arctic smoke configs).

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere): its attention runs
K1 and K2, CUDA C++ for sm_90a with no interpret mode. Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_gpu.py

* Under float32 compute the CUDA engine (K1 decode, K2 window-0 prefill,
  the MoE layer in plain torch) emits the CPU engine's greedy tokens, with
  chunked prefill windows and preemption in the run.
* ``moe_layer`` on CUDA is bitwise repeatable in bf16 (its combine sums a
  token's contributions in a fixed order, without atomics), with and
  without dropped assignments.
* One MoE ``decode_chunk_paged`` runs under
  ``torch.cuda.set_sync_debug_mode("error")``: the dispatch adds no host
  sync (the chunk's one sync is the caller's read of its tokens).
* K1 and K2 at qwen2-moe's attention shapes (H = KV = 16, hd = 128) agree
  with their plain versions within 2e-2 absolute (bf16 outputs of
  magnitude ~1; the tolerance of ``chip_smoke.py``'s KERNEL_TOL).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref
from repro_torch.models import lm, moe
from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
GEOM = dict(decode_chunk=4, prefill_chunk=16, max_batch=4, kv_blocks=20,
            block_size=4, max_admit=2)
KERNEL_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _setup(arch, dt="float32"):
    cfg = dataclasses.replace(get_config(arch).smoke(), compute_dtype=dt)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _to(params, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in params.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_engine_tokens_equal_cpu_engine(cuda, arch):
    cfg, params = _setup(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
               for s in (5, 9, 30, 3, 17, 12)]
    with ServeEngine(cfg, params, device="cpu", **GEOM) as eng:
        ref = eng.generate(prompts, max_new=14)
    ops.reset_launch_counts()
    with ServeEngine(cfg, _to(params, cuda), device=cuda, **GEOM) as eng:
        assert eng.paged and eng.paged_impl == "kernel"
        outs = eng.generate(prompts, max_new=14)
        stats = dict(eng.stats)
    counts = ops.launch_counts()
    for p, a, b in zip(prompts, outs, ref):
        assert a.tolist() == b.tolist(), f"prompt len {len(p)}"
    L = cfg.num_layers
    assert counts["paged_attention"] >= L * stats["decode_cycles"]
    assert counts["flash_attention"] >= L * stats["prefills"] > 0
    assert stats["preempted"] > 0 and stats["prefill_windows"] > 0


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_bitwise_repeatable(cuda, arch, capacity_factor):
    cfg, params = _setup(arch, "bfloat16")
    cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    p = {k: v[0].to(cuda) for k, v in params["blocks"].items()}
    g = torch.Generator(cuda).manual_seed(1)
    x = torch.randn((4, 128, cfg.d_model), generator=g,
                    device=cuda).bfloat16()
    r = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    if capacity_factor < 1:
        assert int((r.rank >= r.capacity).sum()) > 0
    a = moe.moe_layer(p, x, cfg)
    for _ in range(3):
        assert torch.equal(moe.moe_layer(p, x, cfg), a)
    assert torch.isfinite(a.float()).all()


def test_decode_chunk_adds_no_host_sync(cuda):
    cfg, params = _setup("qwen2-moe-a2.7b", "bfloat16")
    params = _to(params, cuda)
    L, bs, N, B, mb = cfg.num_layers, 4, 32, 4, 6
    g = torch.Generator(cuda).manual_seed(2)
    pool = torch.randn((L, 2, N, cfg.num_kv_heads, bs, cfg.hd),
                       generator=g, device=cuda).bfloat16()
    tables = torch.arange(1, 1 + B * mb, dtype=torch.int32,
                          device=cuda).view(B, mb)
    carry = (torch.tensor([3, 7, 0, 11], dtype=torch.int32, device=cuda),
             torch.tensor([5, 9, 1, 2], dtype=torch.int32, device=cuda),
             torch.tensor([6, 6, 0, 6], dtype=torch.int32, device=cuda))
    layers = lm.layer_views(params)
    # warm-up: cached device constants (the rope frequencies) are copied
    # from the host once, outside the checked chunk
    lm.decode_chunk_paged(cfg, params, pool, tables, carry, 2, layers=layers)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, (ln, _, rem), toks = lm.decode_chunk_paged(
            cfg, params, pool, tables, carry, 4, layers=layers)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tuple(toks.shape) == (B, 4)
    assert ln.tolist() == [7, 11, 0, 15] and rem.tolist() == [2, 2, 0, 2]
    assert ops.launch_counts()["paged_attention"] == 4 * L


def test_k1_k2_at_moe_head_shape(cuda):
    """K1: B=8 rows at ragged lengths (a sink row, block-boundary
    positions), H = KV = 16, hd = 128, 16-token pages; K2: the window-0
    shape B=4, S=T=128, causal, and a ragged S."""
    g = torch.Generator(cuda).manual_seed(3)
    B, H, hd, bs, Np, mb = 8, 16, 128, 16, 128, 32
    lengths = [-1, 15, 16, 47, 100, 200, 331, 255]
    q = torch.randn((B, H, hd), generator=g, device=cuda).bfloat16()
    pool = torch.randn((2, Np, H, bs, hd), generator=g,
                       device=cuda).bfloat16()
    perm = np.random.default_rng(3).permutation(np.arange(1, Np))
    tables = np.zeros((B, mb), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        if n >= 0:
            k = n // bs + 1
            tables[b, :k] = perm[used:used + k]
            used += k
    tables = torch.from_numpy(tables).to(cuda)
    ln = torch.tensor([max(n, 0) for n in lengths], dtype=torch.int32,
                      device=cuda)
    out = paged_attention_cuda(q, pool, tables, ln)
    ref = paged_attention_ref(q, pool, tables, ln)
    assert (out.float() - ref.float()).abs().max().item() <= KERNEL_TOL
    for S in (128, 77):
        q, k, v = (torch.randn((4, S, 16, 128), generator=g,
                               device=cuda).bfloat16() for _ in range(3))
        out = flash_attention_cuda(q, k, v)
        ref = flash_attention_ref(q, k, v)
        assert (out.float() - ref.float()).abs().max().item() <= KERNEL_TOL

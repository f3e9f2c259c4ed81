"""The port's serving path on the card against the same path on the CPU.

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere). Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_gpu.py

Under float32 compute the CUDA engine (K1 decode, K2 window-0 prefill)
must emit the CPU engine's greedy tokens (plain page loop and chunked
prefill): the kernels differ from the plain versions only in summation
order, far below these smoke models' top-2 logit margins. The decode step
itself is compared at 1e-4 absolute on the logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

ARCHS = ("stablelm-1.6b", "qwen3-14b", "qwen2.5-32b")
GEOM = dict(decode_chunk=4, prefill_chunk=16, max_batch=4, kv_blocks=20,
            block_size=4, max_admit=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _setup(arch):
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              compute_dtype="float32")
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
        assert eng.paged_impl == "kernel"
        outs = eng.generate(prompts, max_new=14)
        stats = dict(eng.stats)
    counts = ops.launch_counts()
    for p, a, b in zip(prompts, outs, ref):
        assert a.tolist() == b.tolist(), f"prompt len {len(p)}"
    L = cfg.num_layers
    assert counts["paged_attention"] >= L * stats["decode_cycles"]
    assert counts["flash_attention"] >= L * stats["prefills"] > 0
    assert stats["preempted"] > 0 and stats["prefill_windows"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_kernel_matches_gather_on_cuda(cuda, arch):
    cfg, params = _setup(arch)
    params = _to(params, cuda)
    rng = np.random.default_rng(1)
    N, bs, mb, B = 24, 4, 5, 3
    pool = torch.from_numpy(rng.standard_normal(
        (cfg.num_layers, 2, N, cfg.num_kv_heads, bs, cfg.hd))
        .astype(np.float32)).to(cuda)
    tables = torch.from_numpy(rng.permutation(np.arange(1, N))[:B * mb]
                              .reshape(B, mb).astype(np.int32)).to(cuda)
    lengths = torch.tensor([0, 7, 18], dtype=torch.int32, device=cuda)
    token = torch.tensor([3, 7, 9], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, False], device=cuda)
    with torch.inference_mode():
        out = {impl: lm.decode_step_paged(cfg, params, pool.clone(), tables,
                                          lengths, token, active,
                                          impl=impl)[0]
               for impl in ("kernel", "gather")}
    diff = (out["kernel"] - out["gather"])[active].abs().max().item()
    assert diff < 1e-4


def test_bare_cuda_device_resolves_to_an_index(cuda):
    from repro_torch.device import resolve_device
    dev = resolve_device("cuda")
    assert dev.index is not None
    assert torch.zeros(1, device=dev).device == dev

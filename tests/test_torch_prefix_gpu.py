"""Prefix caching, observability and the serve suites on the card.

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere). Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_prefix_gpu.py

``copy_blocks`` on CUDA writes the CPU's bytes. Under float32 compute the
CUDA engine with the prefix cache on (hit rows decode with K1 over shared
blocks, missed rows prefill window 0 with K2, forks copy pool blocks on
the device) emits the same greedy tokens as with it off and as the CPU
engine, on the prefix-share trace. The serve suite (both workloads) and
the observability gate's measurement run on CUDA.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bench import obs_overhead_gate, serve_continuous
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.params import init_params
from repro_torch.serve import kvcache as tkv

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_copy_blocks_on_cuda_equals_cpu(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    pool = torch.randn((3, 2, 40, 2, 8, 64), generator=g).to(dtype)
    srcs = torch.tensor([3, 5, 9, 30], dtype=torch.int32)
    dsts = torch.tensor([7, 3, 11, 2], dtype=torch.int32)
    dev = tkv.copy_blocks(pool.to(cuda), srcs.to(cuda), dsts.to(cuda))
    ref = tkv.copy_blocks(pool.clone(), srcs, dsts)
    assert torch.equal(dev.cpu(), ref)


def _model(dev):
    cfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    return cfg, {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                     if isinstance(v, dict) else v.to(dev))
                 for k, v in params.items()}


def test_warm_tokens_equal_cold_and_cpu_in_fp32(cuda):
    trace, geom = serve_continuous.prefix_share_trace(quick=True)
    cfg, cpu_params = _model("cpu")
    _, params = _model(cuda)
    cpu = serve_continuous.prefix_share_run(cfg, cpu_params, trace, geom,
                                            False, device="cpu")
    ops.reset_launch_counts()
    cold = serve_continuous.prefix_share_run(cfg, params, trace, geom,
                                             False, device=cuda)
    warm = serve_continuous.prefix_share_run(cfg, params, trace, geom,
                                             True, device=cuda)
    counts = ops.launch_counts()
    want = [o.tolist() for o in cpu["outs"]]
    assert [o.tolist() for o in cold["outs"]] == want
    assert [o.tolist() for o in warm["outs"]] == want
    st = warm["stats"]
    assert st["prefix_hits"] > 0 and st["prefix_tokens_saved"] > 0
    assert counts["paged_attention"] > 0 and counts["flash_attention"] > 0
    eng = warm["eng"]
    eng._prefix.evict(eng._prefix.num_nodes)
    assert eng._pool.num_free == eng._pool.num_blocks - 1


def test_serve_suites_and_obs_gate_run_on_cuda(cuda, tmp_path):
    rows = list(serve_continuous.bench(quick=True, device=cuda,
                                       trace_path=str(tmp_path / "t.json")))
    val = {n: v for n, v, _ in rows}
    assert val["serve_continuous_paged_impl"] == "kernel"
    assert float(val["serve_continuous_tok_per_s"]) > 0
    rows = list(serve_continuous.bench_prefix_share(quick=True,
                                                    device=cuda))
    val = {n: v for n, v, _ in rows}
    assert float(val["serve_prefix_hit_rate"]) > 0
    r = obs_overhead_gate.measure(quick=True, device=cuda)
    assert r["off"] > 0 and r["on"] > 0

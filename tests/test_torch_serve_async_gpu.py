"""The decode chunk as a captured CUDA graph, and the async engine, on the
card.

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere). Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_async_gpu.py

In fp32 compute at smoke size, on the four served archs (stablelm dense,
qwen2-moe, falcon-mamba's slot pool, zamba2's hybrid slot pool):

* the engine's default chunk (one CUDA graph replay per chunk) emits the
  eager chunk's (``chunk_graph=False``) tokens, bit for bit, through the
  mixed-length, chunked-prefill, growth-and-preemption geometry of
  ``tests/test_torch_serve.py`` (slot archs: three prompts on two slots,
  one seated in a slot that retired in the chunk before);
* the async engine on the graph emits the sync eager engine's tokens;
* one replay on the paged archs launches K1 once per layer and step: the
  count recorded into the graph, and a profile of the replay (kernels by
  name on the device);
* a replay whose captured tensors were rebound raises.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

ARCHS = ("stablelm-1.6b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
         "zamba2-1.2b")
PAGED = dict(decode_chunk=4, prefill_chunk=16, max_batch=4, kv_blocks=20,
             block_size=4, max_admit=2)
SLOTS = dict(decode_chunk=2, max_batch=2, max_seq_len=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _to(params, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in params.items()}


def _setup(arch, dev):
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    if cfg.ssm or cfg.hybrid_attn_every:
        lens, geom, max_new = (5, 9, 4), SLOTS, 10
    else:
        lens, geom, max_new = (5, 9, 30, 3, 17, 12), PAGED, 14
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
               for s in lens]
    return cfg, _to(params, dev), prompts, geom, max_new


def _serve(cfg, params, prompts, max_new, dev, **kw):
    with ServeEngine(cfg, params, device=dev, **kw) as eng:
        outs = [o.tolist() for o in eng.generate(prompts, max_new)]
        return outs, eng


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_chunk_tokens_equal_eager_chunk(cuda, arch):
    cfg, params, prompts, geom, max_new = _setup(arch, cuda)
    eager, e_eng = _serve(cfg, params, prompts, max_new, cuda,
                          chunk_graph=False, **geom)
    graph, g_eng = _serve(cfg, params, prompts, max_new, cuda, **geom)
    assert e_eng._chunk.graph is None and g_eng._chunk.graph is not None
    assert g_eng._chunk.replays == g_eng.stats["decode_cycles"] > 0
    assert graph == eager


@pytest.mark.parametrize("arch", ARCHS)
def test_async_graph_equals_sync_eager(cuda, arch):
    cfg, params, prompts, geom, max_new = _setup(arch, cuda)
    ref, _ = _serve(cfg, params, prompts, max_new, cuda, chunk_graph=False,
                    **geom)
    outs, eng = _serve(cfg, params, prompts, max_new, cuda,
                       async_decode=True, **geom)
    assert eng.async_decode and eng._chunk.graph is not None
    assert eng._pf_stream is not None
    assert outs == ref
    if eng.paged:
        assert eng._pool.num_deferred == 0
        assert eng._pool.num_free == eng._pool.num_blocks - 1


@pytest.mark.parametrize("arch", ("stablelm-1.6b", "qwen2-moe-a2.7b"))
def test_k1_runs_inside_the_captured_chunk(cuda, arch):
    from torch.profiler import ProfilerActivity, profile
    cfg, params, _, geom, _ = _setup(arch, cuda)
    L, n = cfg.num_layers, geom["decode_chunk"]
    with ServeEngine(cfg, params, device=cuda, **geom) as eng:
        chunk = eng._chunk
        assert chunk.captured_launches.get("paged_attention") == L * n
        before = ops.launch_counts()["paged_attention"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                chunk.run()
            torch.cuda.synchronize()
        assert ops.launch_counts()["paged_attention"] - before == L * n
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    k1 = [x for x in names if "paged_attention_kernel" in x]
    assert len(k1) == L * n, sorted(set(names))


def test_rebound_static_tensor_fails_the_replay(cuda):
    cfg, params, prompts, geom, max_new = _setup("stablelm-1.6b", cuda)
    eng = ServeEngine(cfg, params, device=cuda, **geom)
    try:
        eng._tables_dev = eng._tables_dev.clone()
        with pytest.raises(RuntimeError, match="tables"):
            with torch.inference_mode():
                eng._chunk.run()
    finally:
        eng.close()

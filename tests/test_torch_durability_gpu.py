"""Durable serving and the per-call baseline of the port's engine on the
card, with the decode chunk captured as a CUDA graph.

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere). Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_durability_gpu.py

In fp32 compute at smoke size:

* ``restore()`` writes the snapshot's pages into the live pool in place:
  ``_pkv.data_ptr()`` is unchanged, the chunk captured in the constructor
  replays afterwards (``replays`` grows, nothing is re-captured), the first
  request of a known prefix hits warm, and its tokens equal those of the
  engine that wrote the snapshot, in the synchronous and the async engine;
* a restored pool's pages equal the snapshot's bytes;
* ``_generate_grouped`` on the card equals the CPU engine's tokens on
  stablelm and falcon-mamba (K2 or K3 in its prefill).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.params import init_params
from repro_torch.serve.engine import SNAPSHOT_FILE, ServeEngine
from repro_torch.serve.snapshot import read_snapshot

pytestmark = pytest.mark.gpu

GEOM = dict(max_batch=4, kv_blocks=64, block_size=8, decode_chunk=4)


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
    return cfg, params, _to(params, dev)


def _system_prompts(cfg, n=2, seed=4):
    rng = np.random.default_rng(seed)
    system = np.arange(1, 25, dtype=np.int32)
    return [np.concatenate([system, rng.integers(
        1, cfg.vocab_size, size=k).astype(np.int32)]) for k in (8, 6)[:n]]


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync", "async"])
def test_restore_in_place_keeps_the_capture(cuda, tmp_path, async_decode):
    cfg, _, params = _setup("stablelm-1.6b", cuda)
    prompts = _system_prompts(cfg)
    sp = str(tmp_path / SNAPSHOT_FILE)
    with ServeEngine(cfg, params, prefix_cache=True, device=cuda,
                     async_decode=async_decode, **GEOM) as eng:
        assert eng._chunk.graph is not None
        ref = [eng.result(r) for r in [eng.submit(p, 8) for p in prompts]]
        assert eng.drain()
        eng.snapshot(sp)
    meta, arrays = read_snapshot(sp)
    with ServeEngine(cfg, params, prefix_cache=True, device=cuda,
                     async_decode=async_decode, **GEOM) as eng2:
        graph, ptr = eng2._chunk.graph, eng2._pkv.data_ptr()
        eng2.restore(sp)
        assert eng2._pkv.data_ptr() == ptr
        assert eng2._chunk.graph is graph
        assert eng2.stats["warm_started"] == len(meta["prefix"])
        keyed = {e["key"]: arrays["prefix_pages"][:, :, i]
                 for i, e in enumerate(meta["prefix"])}
        for n in eng2._prefix.export_nodes():
            page = eng2._pkv[:, :, n["block"]].contiguous()
            assert np.array_equal(page.view(torch.uint8).cpu().numpy(),
                                  keyed[n["key"]])
        replays = eng2._chunk.replays
        out = eng2.result(eng2.submit(prompts[0], 8))
        assert eng2._chunk.replays > replays
        assert eng2._prefix.stats["warm_hits"] >= 1
        assert np.array_equal(out, ref[0])


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "falcon-mamba-7b"])
def test_generate_grouped_on_card_equals_cpu(cuda, arch):
    cfg, cpu_params, params = _setup(arch, cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 12, 9, 7)]
    with ServeEngine(cfg, cpu_params, decode_chunk=4, device="cpu") as eng:
        want = eng._generate_grouped(prompts, 12)
    with ServeEngine(cfg, params, decode_chunk=4, device=cuda) as eng:
        got = eng._generate_grouped(prompts, 12)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)

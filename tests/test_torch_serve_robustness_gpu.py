"""SLO overload control and failure isolation of the port's serve engine on
the card, with the decode chunk captured as a CUDA graph.

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere). Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_robustness_gpu.py

In fp32 compute at smoke size, in the synchronous and the async engine:

* ``chunk_sync_exc`` fails the seated rows typed ``RowFailed``; the reset
  is in place, so the ONE capture keeps replaying (no address-check error,
  ``replays`` grows), every block comes back and later requests emit a
  fresh engine's tokens;
* the watchdog fails a request typed ``WatchdogTimeout`` while a replay
  is in flight and the read-back is held (``chunk_latency``);
* the benign spec (admission and growth failures, forced preemptions)
  keeps every request's tokens the fault-free engine's;
* falcon-mamba and zamba2 rows checkpoint-preempted to host memory
  (``preempt:every=3``, sync) resume with the fault-free tokens.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import RowFailed, WatchdogTimeout
from repro_torch.serve.faultinject import FaultInjected

pytestmark = pytest.mark.gpu

BENIGN = "alloc_fail:p=0.05,seed=11;grow_fail:p=0.05,seed=11;preempt:every=5"
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
    return cfg, _to(params, dev)


def _prompts(cfg, n, lo=3, hi=17, seed=0):
    """``n`` prompts of ``lo``..``hi - 1`` tokens: one prefill window each,
    so that a row alone finishes within the benign spec's preemption
    period (``preempt:every=5`` replays a paged row from its prompt)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=int(s)).astype(np.int32)
            for s in rng.integers(lo, hi, size=n)]


def _generate(cfg, params, prompts, max_new, dev, **kw):
    with ServeEngine(cfg, params, device=dev, **kw) as eng:
        return [o.tolist() for o in eng.generate(prompts, max_new)], eng


@pytest.mark.parametrize("async_decode", [False, True])
def test_isolation_keeps_the_one_capture_replaying(cuda, async_decode):
    cfg, params = _setup("stablelm-1.6b", cuda)
    prompts = _prompts(cfg, 6)
    later = _prompts(cfg, 4, seed=1)
    want, _ = _generate(cfg, params, later, 9, cuda, **PAGED)
    with ServeEngine(cfg, params, device=cuda, async_decode=async_decode,
                     fault_inject="chunk_sync_exc:at=3", **PAGED) as eng:
        graph, ptrs = eng._chunk.graph, eng._chunk._pointers()
        reqs = [eng.submit(p, 9) for p in prompts]
        failed = 0
        for r in reqs:
            try:
                r.result(timeout=120.0)
            except RowFailed as e:
                assert isinstance(e.__cause__, FaultInjected)
                failed += 1
        assert failed >= 1 and eng._broken is None
        assert eng._reset_epoch == 1
        assert eng.stats["row_failures"] == failed
        replays = eng._chunk.replays
        got = [o.tolist() for o in eng.generate(later, 9)]
        assert eng._chunk.graph is graph and eng._chunk._pointers() == ptrs
        assert eng._chunk.replays > replays
        assert eng._pool.num_deferred == 0
        assert eng._pool.num_free == eng._pool.num_blocks - 1
    assert got == want


@pytest.mark.parametrize("async_decode", [False, True])
def test_watchdog_fires_with_a_replay_in_flight(cuda, async_decode):
    cfg, params = _setup("stablelm-1.6b", cuda)
    with ServeEngine(cfg, params, device=cuda, async_decode=async_decode,
                     watchdog_s=0.5, fault_inject="chunk_latency:at=2,ms=4000",
                     **PAGED) as eng:
        r = eng.submit(_prompts(cfg, 1)[0], 40)
        t0 = time.perf_counter()
        with pytest.raises(WatchdogTimeout):
            r.result(timeout=30.0)
        waited = time.perf_counter() - t0
        assert waited < 2.0, waited
        assert eng.stats["watchdog_fires"] == 1


@pytest.mark.parametrize("async_decode", [False, True])
def test_benign_faults_keep_tokens_on_the_graph(cuda, async_decode):
    cfg, params = _setup("stablelm-1.6b", cuda)
    prompts = _prompts(cfg, 24)
    want, _ = _generate(cfg, params, prompts, 9, cuda, chunk_graph=False,
                        **PAGED)
    got, eng = _generate(cfg, params, prompts, 9, cuda, fault_inject=BENIGN,
                         async_decode=async_decode, **PAGED)
    assert got == want
    assert eng._chunk.graph is not None
    assert eng.stats["preempted"] > 0
    assert eng._pool.num_free == eng._pool.num_blocks - 1


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_slot_checkpoint_preemption_on_the_graph(cuda, arch):
    cfg, params = _setup(arch, cuda)
    prompts = [np.arange(1, 8, dtype=np.int32),
               np.arange(3, 10, dtype=np.int32),
               np.arange(9, 16, dtype=np.int32)]
    want, _ = _generate(cfg, params, prompts, 12, cuda, **SLOTS)
    got, eng = _generate(cfg, params, prompts, 12, cuda,
                         fault_inject="preempt:every=3", **SLOTS)
    assert got == want
    assert eng.stats["preempted"] > 0
    assert eng.stats["prefills"] == len(prompts)

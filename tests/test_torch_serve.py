"""The port's ServeEngine against the reference engine.

Under float32 compute, the port's engine on the CPU and the JAX engine on
its ``gather`` oracle path serve the same mixed-length prompts — one
longer than ``prefill_chunk`` (chunked prefill windows), a pool tight
enough to force block growth and preemption — and must emit IDENTICAL
greedy tokens (the oracle comparison of ROADMAP Queue 3; the contiguous
comparisons the reference itself fails are not used). Also: no CUDA means
no default engine, unported archs raise typed, and a stage failure fails
every outstanding future instead of hanging ``result()``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.launch import serve as launcher
from repro_torch.params import from_reference, init_params
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import ServeEngine, UnsupportedArch


@pytest.fixture(scope="module")
def fp32_setup():
    cfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(),
                              compute_dtype="float32")
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                        device="cpu")
    return cfg, jp, tp


GEOM = dict(decode_chunk=4, prefill_chunk=16, max_batch=4, kv_blocks=20,
            block_size=4, max_admit=2)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
            for s in lens]


@pytest.fixture(scope="module")
def jax_reference(fp32_setup):
    cfg, jp, _ = fp32_setup
    prompts = _prompts(cfg, [5, 9, 30, 3, 17, 12])
    with JEngine(cfg, jp, paged_impl="gather", **GEOM) as eng:
        outs = eng.generate(prompts, max_new=14)
        stats = dict(eng.stats)
    return prompts, outs, stats


@pytest.mark.parametrize("impl", ["loop", "gather", "kernel"])
def test_tokens_identical_to_jax_gather_engine(fp32_setup, jax_reference,
                                               impl):
    cfg, _, tp = fp32_setup
    prompts, ref, ref_stats = jax_reference
    with ServeEngine(cfg, tp, device="cpu", paged_impl=impl, **GEOM) as eng:
        outs = eng.generate(prompts, max_new=14)
        stats = dict(eng.stats)
        free = eng._pool.num_free
    for p, a, b in zip(prompts, outs, ref):
        assert a.tolist() == b.tolist(), f"prompt len {len(p)}"
    # the run exercised chunked prefill, growth and preemption, as the
    # reference's did, and returned every block
    assert stats["prefill_windows"] > 0 and stats["grown_blocks"] > 0
    assert stats["preempted"] > 0
    for key in ("admitted", "prefills", "prefill_windows", "tokens_out",
                "grown_blocks", "preempted", "retired"):
        assert stats[key] == ref_stats[key], key
    assert free == GEOM["kv_blocks"] - 1


def test_submit_mid_decode_and_staggered_arrivals(fp32_setup):
    cfg, _, tp = fp32_setup
    prompts = _prompts(cfg, [6, 11, 4], seed=1)
    with ServeEngine(cfg, tp, device="cpu", decode_chunk=2,
                     record_stages=True) as eng:
        solo = [eng.generate([p], max_new=8)[0] for p in prompts]
        ra = eng.submit(prompts[0], max_new=8)
        rb = eng.submit(prompts[1], max_new=8, priority=1)
        rc = eng.submit(prompts[2], max_new=8)
        outs = [eng.result(r) for r in (ra, rb, rc)]
        assert all(r.ttft is not None and r.ttft > 0 for r in (ra, rb, rc))
        kinds = {e[0] for e in eng.stage_log}
    for a, b in zip(outs, solo):        # batching does not change tokens
        assert a.tolist() == b.tolist()
    assert {"admit", "prefill", "decode", "complete"} <= kinds


def test_default_engine_needs_cuda(fp32_setup):
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal")
    cfg, _, tp = fp32_setup
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, tp)
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--max-new", "2", "--batch", "1"])


def test_params_on_another_device_are_refused(fp32_setup):
    cfg, _, tp = fp32_setup
    with pytest.raises(ValueError, match="the engine on meta"):
        ServeEngine(cfg, tp, device="meta")


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "internvl2-1b"])
def test_unported_archs_raise_typed(arch):
    """Frontend archs raise typed; qwen2-moe (MoE) is served through the
    paged pool like a dense arch, falcon-mamba (Mamba1) and zamba2 (the
    Mamba2 hybrid) through the slot-state pool instead of pages."""
    cfg = get_config(arch).smoke()
    slots = {"falcon-mamba-7b": {"ssm"},
             "zamba2-1.2b": {"g_ssm", "tail_ssm", "shared_k", "shared_v"}}
    if arch in slots or cfg.moe:
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        with ServeEngine(cfg, params, device="cpu") as eng:
            if cfg.moe:
                assert eng.paged is True and eng.paged_impl == "loop"
                assert eng._pool is not None
            else:
                assert eng.paged is False and eng.paged_impl is None
                assert eng._pool is None and set(eng._sstate) == slots[arch]
        return
    with pytest.raises(UnsupportedArch):
        ServeEngine(cfg, {}, device="cpu")


def test_stage_failure_fails_every_outstanding_future(fp32_setup,
                                                      monkeypatch):
    cfg, _, tp = fp32_setup

    def boom(*a, **k):
        raise RuntimeError("injected decode failure")

    monkeypatch.setattr(tengine.lm, "decode_chunk_paged", boom)
    eng = ServeEngine(cfg, tp, device="cpu")
    try:
        reqs = [eng.submit(p, max_new=4) for p in _prompts(cfg, [5, 7, 3])]
        for r in reqs:
            with pytest.raises(RuntimeError):
                r.result(timeout=60)
        with pytest.raises(RuntimeError, match="broken"):
            eng.submit(np.array([1, 2], np.int32), max_new=2)
    finally:
        eng.close(timeout=5)


def test_launcher_runs_on_cpu(capsys):
    launcher.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                   "--max-new", "4", "--stagger", "0.01"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "sample:" in out and "device=cpu" in out

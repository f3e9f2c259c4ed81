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
        lost = tally_discarded(eng)
        outs = eng.generate(prompts, max_new=14)
        stats = dict(eng.stats)
    return prompts, outs, stats, lost


@pytest.mark.parametrize("impl", ["loop", "gather", "kernel"])
def test_tokens_identical_to_jax_gather_engine(fp32_setup, jax_reference,
                                               impl):
    cfg, _, tp = fp32_setup
    prompts, ref, ref_stats, ref_lost = jax_reference
    with ServeEngine(cfg, tp, device="cpu", paged_impl=impl, **GEOM) as eng:
        lost = tally_discarded(eng)
        outs = eng.generate(prompts, max_new=14)
        stats = dict(eng.stats)
        free = eng._pool.num_free
    for p, a, b in zip(prompts, outs, ref):
        assert a.tolist() == b.tolist(), f"prompt len {len(p)}"
    # the run exercised chunked prefill, growth and preemption, as the
    # reference's did, and returned every block
    assert stats["prefill_windows"] > 0 and stats["grown_blocks"] > 0
    assert stats["preempted"] > 0
    check_stats(stats, ref_stats, outs, lost, ref_lost, GEOM["max_admit"])
    assert free == GEOM["kv_blocks"] - 1


class Tally:
    """What the test-side wraps of one paged engine saw (see
    :func:`tally_discarded`): ``lost`` decode tokens thrown away at
    preemptions, ``launches`` prefill-window launches, and per seat (a
    request's admission, keyed ``(id, preempted_count)``) its prompt and
    ``max_new``, the windows it needed past its first at seating, the
    windows launched with it, the blocks it grew, whether it was preempted
    and the blocks it held then."""

    def __init__(self):
        self.lost = 0
        self.launches = 0
        self.seats = {}


def tally_discarded(eng):
    """Wrap ``eng``'s preemption, seating (the merge of an admitted group),
    prefill-window launch and table growth test-side, as the engines
    themselves keep no per-seat record. Works on the port's engine and the
    JAX engine alike (they share these method names). Returns the
    :class:`Tally` the wraps fill."""
    t = Tally()
    preempt, merge = eng._preempt, eng._merge_group
    window, grow = eng._dispatch_window_prefill, eng._pool.grow_table

    def seat(req):
        return t.seats[(req.id, req.preempted_count)]

    def counted_preempt(slot, pf):
        req = eng._slot_req[slot]
        t.lost += max(0, len(eng._slot_out[slot] or []) - 1)
        s = seat(req)
        s["preempted"] = True
        s["held"] = len(eng._slot_blocks[slot])
        return preempt(slot, pf)

    def counted_merge(pf, payload):
        merge(pf, payload)
        for g in payload[0]:
            req = g[0]
            slot = next(b for b, r in enumerate(eng._slot_req) if r is req)
            left = req.prompt_len - int(eng._pref_pos[slot])
            t.seats[(req.id, req.preempted_count)] = {
                "P": req.prompt_len, "M": req.max_new,
                "needed": -(-left // eng.prefill_chunk), "launched": 0,
                "grown": 0, "preempted": False, "held": None}

    def counted_window(pf):
        pend = window(pf)
        if pend is not None:
            t.launches += 1
            for b in pend["rows"]:
                seat(eng._slot_req[b])["launched"] += 1
        return pend

    def counted_grow(blocks, n, **kw):
        ids = grow(blocks, n, **kw)
        if ids is not None:
            slot = next(b for b, bl in enumerate(eng._slot_blocks)
                        if bl is blocks)
            seat(eng._slot_req[slot])["grown"] += len(ids)
        return ids

    eng._preempt = counted_preempt
    eng._merge_group = counted_merge
    eng._dispatch_window_prefill = counted_window
    eng._pool.grow_table = counted_grow
    return t


def check_schedule(stats, t, block_size):
    """Exact invariants of one engine's prefill windows and growth, from
    its :class:`Tally`. A seat launches every window its prompt needs past
    where it was seated (window 0 or its cached prefix) unless it is
    preempted first; ``prefill_windows`` counts launches. A seat's table
    starts at the prompt's blocks and grows to cover every position it
    writes: ``prompt + max_new - 1`` when it retires (the last token's KV
    is never written), what it held when preempted otherwise; every grown
    block is in ``grown_blocks``."""
    def blocks(n):
        return -(-n // block_size)
    assert stats["prefill_windows"] == t.launches
    total = 0
    for key, s in t.seats.items():
        if s["preempted"]:
            assert s["launched"] <= s["needed"], (key, s)
            assert s["grown"] == s["held"] - blocks(s["P"]), (key, s)
        else:
            assert s["launched"] == s["needed"], (key, s)
            assert s["grown"] == blocks(s["P"] + s["M"] - 1) \
                - blocks(s["P"]), (key, s)
        total += s["grown"]
    assert stats["grown_blocks"] == total


def check_stats(stats, ref_stats, outs, lost, ref_lost, max_admit,
                block_size=GEOM["block_size"]):
    """Which rows are admitted together, and so which are preempted, depends
    on thread timing in both engines: the PARALLEL complete stage frees a
    cycle's blocks while the next cycle's admission and growth run. So the
    counts that follow the schedule are held to exact invariants on each
    engine (``lost`` and ``ref_lost`` are each engine's :class:`Tally`;
    windows and growth by :func:`check_schedule`), ``prefills`` to its
    bounds, and ``retired`` to equality."""
    n = len(outs)
    kept = sum(len(o) - 1 for o in outs)  # decode tokens of retired runs
    assert stats["retired"] == ref_stats["retired"] == n
    for st, t in ((stats, lost), (ref_stats, ref_lost)):
        # every admission is a request's first or follows its preemption
        assert st["admitted"] == n + st["preempted"]
        assert len(t.seats) == st["admitted"]
        # every decoded token was returned or thrown away at a preemption
        assert st["tokens_out"] == kept + t.lost
        # one prefill launch per admitted group of 1..max_admit requests
        assert -(-st["admitted"] // max_admit) <= st["prefills"] \
            <= st["admitted"]
        check_schedule(st, t, block_size)


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

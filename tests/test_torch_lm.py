"""The port's LM serving entry points against ``repro.models.lm`` on the
dense smoke configs (stablelm: MHA; qwen3-14b: qk_norm + GQA; qwen2.5-32b:
qkv_bias + GQA + bf16 params), with the reference's own weights
(PRNGKey(0)) carried over by ``from_reference``.

Tolerances: float32 compute — logits 1e-4 absolute and identical greedy
tokens; bfloat16 compute — logits 3e-2 absolute (XLA and PyTorch round
bf16 activations at different places; measured ~6e-3 on these configs).
Paged impls are compared like with like: kernel <-> pallas (interpret),
loop <-> xla, gather <-> gather.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.models import lm as tlm
from repro_torch.params import init_params, to_torch
from test_torch_parity import ARCHS, assert_close, ref_params, smoke_cfg, to_np

LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
IMPLS = [("kernel", "pallas"), ("loop", "xla"), ("gather", "gather")]


def _setup(arch, dt):
    cfg = smoke_cfg(arch, dt)
    jp, tp = ref_params(cfg)
    return cfg, jp, tp


def _paged_state(cfg, seed=0, N=16, bs=4, mb=4, B=3):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((cfg.num_layers, 2, N, cfg.num_kv_heads, bs,
                                cfg.hd)).astype(np.float32)
    jpool = jnp.asarray(pool).astype(jnp.dtype(cfg.compute_dtype))
    tables = rng.permutation(np.arange(1, N))[:B * mb].reshape(B, mb) \
        .astype(np.int32)
    return jpool, tables


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_last_positions(arch, dt):
    cfg, jp, tp = _setup(arch, dt)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 9)) \
        .astype(np.int32)
    lp = np.array([8, 4, 6], np.int32)
    jl, jc = jlm.prefill(cfg, jp, jnp.asarray(toks), max_len=12,
                         last_positions=jnp.asarray(lp))
    tl, tc = tlm.prefill(cfg, tp, torch.from_numpy(toks), max_len=12,
                         last_positions=torch.from_numpy(lp))
    assert tl.dtype == torch.float32
    assert_close(tl, jl, LOGIT_TOL[dt], "prefill logits")
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert_close(tc[key], jc[key], LOGIT_TOL[dt] * 4, f"cache {key}")
    # no last_positions: the final position's logits
    jl2, _ = jlm.prefill(cfg, jp, jnp.asarray(toks))
    tl2, _ = tlm.prefill(cfg, tp, torch.from_numpy(toks))
    assert_close(tl2, jl2, LOGIT_TOL[dt], "prefill logits (last)")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_flash_impl_matches_chunked(arch):
    """``impl="flash"`` (K2; its plain version on the CPU) and the
    reference's chunked path give the same logits and cache."""
    cfg, _, tp = _setup(arch, "float32")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    lf, cf = tlm.prefill(cfg, tp, toks, impl="flash")
    lc, cc = tlm.prefill(cfg, tp, toks, impl="chunked")
    assert_close(lf, lc, 1e-4, "flash vs chunked")
    assert_close(cf["k"], cc["k"], 1e-5, "cache k")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged_all_impls(arch, dt):
    cfg, jp, tp = _setup(arch, dt)
    jpool, tables = _paged_state(cfg)
    lens = np.array([0, 5, 11], np.int32)
    tok = np.array([3, 7, 9], np.int32)
    act = np.array([True, True, False])
    for timpl, jimpl in IMPLS:
        jl, jpo = jlm.decode_step_paged(cfg, jp, jpool, jnp.asarray(tables),
                                        jnp.asarray(lens), jnp.asarray(tok),
                                        jnp.asarray(act), impl=jimpl)
        tpool = to_torch(np.asarray(jpool))
        tl, tpo = tlm.decode_step_paged(cfg, tp, tpool,
                                        torch.from_numpy(tables),
                                        torch.from_numpy(lens),
                                        torch.from_numpy(tok),
                                        torch.from_numpy(act), impl=timpl)
        assert tpo is tpool                  # written in place
        assert_close(tl[act], np.asarray(jl)[act], LOGIT_TOL[dt],
                     f"decode logits {timpl}")
        # pool bytes: exact for fp32; in bf16 the new K/V are computed by
        # the two frameworks, so allow their few-ulp difference
        diff = np.abs(to_np(tpo)[:, :, 1:] - to_np(jpo)[:, :, 1:])
        assert diff.max() <= (0 if dt == "float32" else 4 * LOGIT_TOL[dt]) \
            + 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_paged_tokens(arch):
    """fp32 compute: the chunk program's greedy tokens and carry equal the
    reference's (loop <-> xla)."""
    cfg, jp, tp = _setup(arch, "float32")
    jpool, tables = _paged_state(cfg, seed=2, N=24, mb=6)
    carry = (np.array([3, 0, 9], np.int32), np.array([5, 1, 2], np.int32),
             np.array([6, 0, 2], np.int32))
    jpo, jc, jt = jlm.decode_chunk_paged(
        cfg, jp, jpool, jnp.asarray(tables),
        tuple(jnp.asarray(c) for c in carry), 6, impl="xla")
    tpo, tc, tt = tlm.decode_chunk_paged(
        cfg, tp, to_torch(np.asarray(jpool)), torch.from_numpy(tables),
        tuple(torch.from_numpy(c) for c in carry), 6, impl="loop")
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for a, b in zip(tc, jc):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, 6)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_window_paged(arch, dt):
    cfg, jp, tp = _setup(arch, dt)
    jpool, tables = _paged_state(cfg, seed=3, N=20, mb=5)
    rng = np.random.default_rng(4)
    C = 6
    toks = rng.integers(0, cfg.vocab_size, (3, C)).astype(np.int32)
    start = np.array([4, 0, 8], np.int32)
    valid = np.array([[1] * 6, [1, 1, 1, 0, 0, 0], [0] * 6], bool)
    last = np.array([5, 2, 0], np.int32)
    jf, jpo = jlm.prefill_window_paged(cfg, jp, jpool, jnp.asarray(tables),
                                       jnp.asarray(toks), jnp.asarray(start),
                                       jnp.asarray(valid), jnp.asarray(last))
    tf, tpo = tlm.prefill_window_paged(
        cfg, tp, to_torch(np.asarray(jpool)), torch.from_numpy(tables),
        torch.from_numpy(toks), torch.from_numpy(start),
        torch.from_numpy(valid), torch.from_numpy(last))
    if dt == "float32":
        assert np.array_equal(tf.numpy()[:2], np.asarray(jf)[:2])
    diff = np.abs(to_np(tpo)[:, :, 1:] - to_np(jpo)[:, :, 1:])
    assert diff.max() <= (1e-5 if dt == "float32" else 4 * LOGIT_TOL[dt])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "musicgen-large"])
def test_entry_points_refuse_unported_archs(arch):
    """The paged entry points take attention archs, MoE included, as the
    reference's do (an SSM or the zamba2 hybrid keeps its state per
    sequence in the slot pool); prefill takes qwen2-moe, falcon-mamba
    (Mamba1) and zamba2 (the Mamba2 hybrid) and refuses the unported rest
    (modality frontends)."""
    cfg = smoke_cfg(arch)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    if arch != "musicgen-large":
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        logits, _ = tlm.prefill(cfg, params, toks)
        assert tuple(logits.shape) == (1, cfg.padded_vocab)
    else:
        with pytest.raises(ValueError):
            tlm.prefill(cfg, {}, toks)
    if cfg.moe:
        # MoE pages its KV: the three paged entry points serve it
        pool = torch.zeros((cfg.num_layers, 2, 8, cfg.num_kv_heads, 4,
                            cfg.hd), dtype=torch.bfloat16)
        tables = torch.arange(1, 5, dtype=torch.int32)[None]
        first, _ = tlm.prefill_window_paged(
            cfg, params, pool, tables, toks, torch.tensor([0]),
            torch.ones((1, 4), dtype=torch.bool), torch.tensor([3]))
        assert int(first[0]) == int(torch.argmax(logits[0]))
        step, _ = tlm.decode_step_paged(
            cfg, params, pool, tables, torch.tensor([4], dtype=torch.int32),
            first, torch.tensor([True]))
        assert tuple(step.shape) == (1, cfg.padded_vocab)
        _, _, chunk = tlm.decode_chunk_paged(
            cfg, params, pool, tables,
            (torch.tensor([5], dtype=torch.int32), first,
             torch.tensor([3], dtype=torch.int32)), 3)
        assert tuple(chunk.shape) == (1, 3)
        return
    with pytest.raises(ValueError):
        tlm.decode_step_paged(cfg, {}, None, None, None, None, None)
    with pytest.raises(ValueError):
        tlm.decode_chunk_paged(cfg, {}, None, None, None, 1)
    with pytest.raises(ValueError):
        tlm.prefill_window_paged(cfg, {}, None, None, toks, None, None,
                                 None)


def test_layer_views_passed_in_match_per_call_views():
    """``layer_views`` are views into the stacked leaves (no copy), and an
    entry point given them (as the engine does) computes what it computes
    when it builds its own."""
    cfg = smoke_cfg("stablelm-1.6b", "float32")
    _, tp = ref_params(cfg)
    views = tlm.layer_views(tp)
    assert len(views) == cfg.num_layers
    assert views[1]["wq"].data_ptr() == tp["blocks"]["wq"][1].data_ptr()
    assert set(views[0]) == set(tp["blocks"])
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32))
    la, ca = tlm.prefill(cfg, tp, toks)
    lb, cb = tlm.prefill(cfg, tp, toks, layers=views)
    assert torch.equal(la, lb) and torch.equal(ca["k"], cb["k"])

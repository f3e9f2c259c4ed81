"""The port's paged serving entry points on the MoE smoke configs
(qwen2-moe: shared experts; arctic: dense residual) against
``repro.models.lm``, with the reference's own weights (PRNGKey(0)) carried
over by ``from_reference``: ``prefill`` (logits and KV cache, with
``last_positions``), ``prefill_window_paged`` (first tokens and the pool)
and ``decode_step_paged`` (logits and the pool; the plain page loop
against the reference's ``xla`` loop, gather against gather), and
``decode_chunk_paged``'s greedy tokens and carry.

Tolerances as ``tests/test_torch_lm.py``: float32 compute — logits 1e-4
absolute and identical greedy tokens; bfloat16 compute — logits 3e-2
absolute. The JAX references are jitted (one XLA program per config and
shape).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.models import lm as tlm
from repro_torch.params import from_reference
from test_torch_parity import assert_close, smoke_cfg, to_np, to_torch

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}

j_prefill = jax.jit(jlm.prefill, static_argnums=(0,),
                    static_argnames=("max_len",))
j_window = jax.jit(jlm.prefill_window_paged, static_argnums=(0,))
j_step = jax.jit(jlm.decode_step_paged, static_argnums=(0,),
                 static_argnames=("impl",))
j_chunk = jax.jit(jlm.decode_chunk_paged, static_argnums=(0, 5),
                  static_argnames=("impl",))


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """The reference's params as numpy, built once per arch (the tree
    depends on ``param_dtype`` only, not on the compute dtype)."""
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        smoke_cfg(arch), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _setup(arch, dt):
    cfg = smoke_cfg(arch, dt)
    tree = _ref_tree(arch)
    return (cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            from_reference(tree, cfg, device="cpu"))


def _paged_state(cfg, seed, N=16, bs=4, mb=4, B=3):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((cfg.num_layers, 2, N, cfg.num_kv_heads, bs,
                                cfg.hd)).astype(np.float32)
    jpool = jnp.asarray(pool).astype(jnp.dtype(cfg.compute_dtype))
    tables = rng.permutation(np.arange(1, N))[:B * mb].reshape(B, mb) \
        .astype(np.int32)
    return jpool, tables


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill(arch, dt):
    cfg, jp, tp = _setup(arch, dt)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 9)) \
        .astype(np.int32)
    lp = np.array([8, 4, 6], np.int32)
    jl, jc = j_prefill(cfg, jp, jnp.asarray(toks), max_len=12,
                       last_positions=jnp.asarray(lp))
    tl, tc = tlm.prefill(cfg, tp, torch.from_numpy(toks), max_len=12,
                         last_positions=torch.from_numpy(lp))
    assert tl.dtype == torch.float32
    assert_close(tl, jl, LOGIT_TOL[dt], "prefill logits")
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert_close(tc[key], jc[key], LOGIT_TOL[dt] * 4, f"cache {key}")


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
    jf, jpo = j_window(cfg, jp, jpool, jnp.asarray(tables),
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


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_paged(arch, dt):
    cfg, jp, tp = _setup(arch, dt)
    jpool, tables = _paged_state(cfg, seed=0)
    lens = np.array([0, 5, 11], np.int32)
    tok = np.array([3, 7, 9], np.int32)
    act = np.array([True, True, False])
    for timpl, jimpl in (("loop", "xla"), ("gather", "gather")):
        jl, jpo = j_step(cfg, jp, jpool, jnp.asarray(tables),
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
        diff = np.abs(to_np(tpo)[:, :, 1:] - to_np(jpo)[:, :, 1:])
        assert diff.max() <= (0 if dt == "float32" else 4 * LOGIT_TOL[dt]) \
            + 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_paged_tokens(arch):
    """fp32 compute: the chunk program's greedy tokens and carry equal the
    reference's (loop <-> xla); an inactive row routes and takes capacity
    as the reference's does."""
    cfg, jp, tp = _setup(arch, "float32")
    jpool, tables = _paged_state(cfg, seed=2, N=24, mb=6)
    carry = (np.array([3, 0, 9], np.int32), np.array([5, 1, 2], np.int32),
             np.array([6, 0, 2], np.int32))
    jpo, jc, jt = j_chunk(cfg, jp, jpool, jnp.asarray(tables),
                          tuple(jnp.asarray(c) for c in carry), 6,
                          impl="xla")
    tpo, tc, tt = tlm.decode_chunk_paged(
        cfg, tp, to_torch(np.asarray(jpool)), torch.from_numpy(tables),
        tuple(torch.from_numpy(c) for c in carry), 6, impl="loop")
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for a, b in zip(tc, jc):
        assert np.array_equal(a.numpy(), np.asarray(b))

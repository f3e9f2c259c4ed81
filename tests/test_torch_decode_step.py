"""The port's contiguous decode path (the per-call baseline's) against
``repro.models``, with the reference's own weights (PRNGKey(0)) carried
over by ``from_reference``.

* ``attention.decode_attention``: one token against a (B, KV, S_max, hd)
  cache at a scalar position, output and both written caches;
* ``lm.init_cache``: the reference's leaves, shapes and dtypes on every
  served family (the attention branch is new here);
* ``lm.decode_step`` after ``lm.prefill``, three steps, per op: logits
  and every cache leaf after each step, on the smoke configs of
  stablelm-1.6b, qwen2-moe-a2.7b, falcon-mamba-7b and zamba2-1.2b;
* the port's side of ``tests/test_models_smoke.py::
  test_prefill_decode_matches_forward`` (bf16, the reference's bounds);
* ``ServeEngine._generate_grouped``: fp32 tokens equal the JAX engine's
  ``_generate_grouped`` on mixed-length prompts.

Tolerances: float32 compute — logits 1e-4 absolute, cache leaves 2e-5
absolute (as ``tests/test_torch_lm_hybrid.py``); the forward check keeps
the reference test's own bounds (prefill 2e-2 relative, the next-token
distribution 5e-3). Every JAX oracle is jitted and built once per module.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.params import from_reference
from repro_torch.serve.engine import ServeEngine
from test_torch_parity import assert_close, to_np

ARCHS = ("stablelm-1.6b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
         "zamba2-1.2b")
LOGIT_TOL = 1e-4
STATE_TOL = 2e-5

j_prefill = jax.jit(jlm.prefill, static_argnums=(0,),
                    static_argnames=("max_len",))
j_decode_step = jax.jit(jlm.decode_step, static_argnums=(0,))


@functools.lru_cache(maxsize=None)
def _setup(arch, dt="float32"):
    cfg = dataclasses.replace(get_config(arch).smoke(), compute_dtype=dt)
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return cfg, jp, from_reference(tree, cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _leaves(cache):
    """(name, array) of a cache's tensor leaves, tuples unrolled."""
    for name in sorted(k for k in cache if k != "pos"):
        v = cache[name]
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            yield f"{name}.{i}", t


def test_decode_attention_matches_reference():
    cfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(),
                              compute_dtype="float32")
    _, jp, tp = _setup("stablelm-1.6b")
    lp_t = {k: v[0] for k, v in tp["blocks"].items()}
    lp_j = jax.tree_util.tree_map(lambda v: v[0], jp["blocks"])
    rng = np.random.default_rng(3)
    B, S_max, pos = 2, 12, 7
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, cfg.num_kv_heads, S_max, cfg.hd)
                             ).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    yj, kj, vj = jax.jit(jattn.decode_attention, static_argnums=(2,))(
        lp_j, x, cfg, ck, cv, pos)
    kt, vt = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    yt, kt2, vt2 = tattn.decode_attention(lp_t, torch.from_numpy(x), cfg,
                                          kt, vt, pos)
    assert kt2 is kt and vt2 is vt            # written in place
    assert_close(yt, yj, LOGIT_TOL, "y")
    assert_close(kt, kj, STATE_TOL, "cache_k")
    assert_close(vt, vj, STATE_TOL, "cache_v")
    # keys past pos are neither written nor read
    assert np.array_equal(kt[:, :, pos + 1:].numpy(), ck[:, :, pos + 1:])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch, dt):
    cfg = dataclasses.replace(get_config(arch).smoke(), compute_dtype=dt)
    jc = jax.eval_shape(lambda: jlm.init_cache(cfg, 3, 20))
    tc = tlm.init_cache(cfg, 3, 20, device="cpu")
    assert tc["pos"] == 0
    jl, tl = dict(_leaves(jc)), dict(_leaves(tc))
    assert sorted(jl) == sorted(tl)
    for name, t in tl.items():
        assert tuple(t.shape) == tuple(jl[name].shape), name
        assert str(t.dtype).rpartition(".")[2] == str(jl[name].dtype), name
        assert not t.any(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_per_op(arch):
    cfg, jp, tp = _setup(arch)
    B, S, steps = 2, 10, 3
    toks = _tokens(cfg, B, S, seed=1)
    lj, cj = j_prefill(cfg, jp, jnp.asarray(toks), max_len=S + steps + 1)
    lt, ct = tlm.prefill(cfg, tp, torch.from_numpy(toks),
                         max_len=S + steps + 1)
    assert_close(lt, lj, LOGIT_TOL, f"{arch} prefill logits")
    cur = np.argmax(np.asarray(lj), axis=-1).astype(np.int32)
    layers = tlm.layer_views(tp)
    for step in range(steps):
        lj, cj = j_decode_step(cfg, jp, cj, jnp.asarray(cur))
        lt, ct = tlm.decode_step(cfg, tp, ct, torch.from_numpy(cur),
                                 layers=layers)
        assert ct["pos"] == int(cj["pos"]) == S + step + 1
        assert_close(lt, lj, LOGIT_TOL, f"{arch} step {step} logits")
        jl = dict(_leaves(cj))
        for name, t in _leaves(ct):
            assert_close(t, jl[name], STATE_TOL, f"{arch} step {step} {name}")
        nxt = np.argmax(to_np(lt), axis=-1).astype(np.int32)
        assert np.array_equal(nxt, np.argmax(np.asarray(lj), axis=-1))
        cur = nxt


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's side of the reference's smoke check: prefill S-1 tokens,
    one decode step, against teacher-forced logits (the port's
    ``forward`` on attention archs, the reference's on the Mamba families,
    whose training forward the port does not have yet)."""
    cfg, jp, tp = _setup(arch, "bfloat16")
    B, S = 2, 24
    toks = _tokens(cfg, B, S, seed=2)
    if cfg.ssm:
        full = np.array(jax.jit(jlm.forward, static_argnums=(0,))(
            cfg, jp, jnp.asarray(toks))[0])
    else:
        with torch.no_grad():
            full = tlm.forward(cfg, tp, torch.from_numpy(toks))[0].numpy()
    lp, cache = tlm.prefill(cfg, tp, torch.from_numpy(toks[:, :S - 1]),
                            max_len=S + 4)
    ref = full[:, S - 2]
    err = float(np.max(np.abs(to_np(lp) - ref))) \
        / (float(np.max(np.abs(ref))) + 1e-6)
    assert err < 2e-2, f"prefill mismatch {err}"
    ld, cache2 = tlm.decode_step(cfg, tp, cache,
                                 torch.from_numpy(toks[:, S - 1]))
    p1 = torch.softmax(torch.from_numpy(to_np(ld)[:, :cfg.vocab_size]), -1)
    p2 = torch.softmax(torch.from_numpy(full[:, S - 1, :cfg.vocab_size]),
                       -1)
    perr = float((p1 - p2).abs().max())
    assert perr < 5e-3, f"decode distribution mismatch {perr}"
    assert cache2["pos"] == cache["pos"] + 1


@functools.lru_cache(maxsize=None)
def _jax_grouped(arch, prompts_key, max_new):
    cfg, jp, _ = _setup(arch)
    prompts = [np.asarray(p, np.int32) for p in prompts_key]
    with JEngine(cfg, jp, decode_chunk=4) as eng:
        return [np.asarray(o) for o in eng._generate_grouped(prompts,
                                                              max_new)]


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "falcon-mamba-7b"])
def test_generate_grouped_tokens_equal_jax_engine(arch):
    cfg, _, tp = _setup(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 12, 9, 7)]
    max_new = 10
    want = _jax_grouped(arch, tuple(tuple(p.tolist()) for p in prompts),
                        max_new)
    with ServeEngine(cfg, tp, decode_chunk=4, device="cpu") as eng:
        got = eng._generate_grouped(prompts, max_new)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == (max_new,), (i, a.shape)
        assert np.array_equal(a, b), f"request {i}: {a} != {b}"

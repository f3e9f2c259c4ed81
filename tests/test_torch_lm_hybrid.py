"""The port's zamba2 hybrid serving entry points against ``repro.models.lm``,
with the reference's own weights (PRNGKey(0)) carried over by
``from_reference``.

Two configs: the zamba2 smoke config (3 layers, a shared block every 2:
G = 1 group and a tail of 1) and a 5-layer variant (G = 2, tail 1), where
the shared block's weights serve both groups, each with its own KV span.

* ``prefill``: logits and the four state leaves (``g_ssm``, ``tail_ssm``,
  ``shared_k``, ``shared_v``), with and without ``last_positions``, with a
  ``max_len`` beyond the prompt;
* ``init_cache`` and ``layer_views``: the reference's hybrid shapes, dtypes
  and layer order;
* ``decode_step_slots`` at per-row positions, every leaf updated in place;
  ``decode_chunk_slots``: greedy tokens and carry;
* 1- and 2-token prompts, shorter than the conv window: the oracle is the
  reference's ``decode_step`` fed the prompt token by token.

Tolerances: float32 compute — logits 1e-4 absolute, state leaves 2e-5,
identical greedy tokens; bfloat16 compute — logits 3e-2 absolute (as
``tests/test_torch_lm.py``), state leaves 3e-2 x max(1, max |reference|)
(one bf16 ulp is 2**-8 of the magnitude, and XLA and PyTorch round bf16
activations at different places).
"""
import dataclasses
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

ARCH = "zamba2-1.2b"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STATE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LEAVES = ("g_ssm", "tail_ssm", "shared_k", "shared_v")

# the reference entry points, jitted (one XLA program per shape instead of
# an eager dispatch per op)
j_prefill = jax.jit(jlm.prefill, static_argnums=(0,),
                    static_argnames=("max_len",))
j_step_slots = jax.jit(jlm.decode_step_slots, static_argnums=(0,))
j_decode_step = jax.jit(jlm.decode_step, static_argnums=(0,))


def _cfg(dt, layers):
    return dataclasses.replace(smoke_cfg(ARCH, dt), num_layers=layers)


@functools.lru_cache(maxsize=None)
def _ref_tree(layers):
    """The reference's params as numpy, built once per depth (the tree
    depends on ``param_dtype`` only, not on the compute dtype)."""
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        _cfg("float32", layers), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _setup(dt, layers=3):
    cfg = _cfg(dt, layers)
    tree = _ref_tree(layers)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg, jp, from_reference(tree, cfg, device="cpu")


def _flat(cache):
    """(name, tensor) of a cache's state leaves, tuples unrolled."""
    for name in LEAVES:
        v = cache[name]
        for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
            yield f"{name}.{i}", t


def _close_state(t, j, dt, what):
    scale = 1.0 if dt == "float32" else max(1.0, float(np.abs(to_np(j)).max()))
    assert_close(t, j, STATE_TOL[dt] * scale, what)


def _state(jcache):
    """The port's slot state from a reference cache (``pos`` dropped)."""
    return {k: (tuple(to_torch(np.asarray(a)) for a in v)
                if isinstance(v, tuple) else to_torch(np.asarray(v)))
            for k, v in jcache.items() if k != "pos"}


@pytest.mark.parametrize("layers", [3, 5])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_prefill_logits_and_state(dt, layers):
    cfg, jp, tp = _setup(dt, layers)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 11)) \
        .astype(np.int32)
    lp = np.array([10, 4, 7], np.int32)
    for last in (None, lp):
        jl, jc = j_prefill(cfg, jp, jnp.asarray(toks), max_len=16,
                           last_positions=None if last is None
                           else jnp.asarray(last))
        tl, tc = tlm.prefill(cfg, tp, torch.from_numpy(toks), max_len=16,
                             last_positions=None if last is None
                             else torch.from_numpy(last))
        assert tl.dtype == torch.float32 and tc["pos"] == 11
        assert set(tc) == set(jc) == {"pos", *LEAVES}
        assert_close(tl, jl, LOGIT_TOL[dt], "prefill logits")
        for (name, t), (_, j) in zip(_flat(tc), _flat(jc)):
            assert str(t.dtype).split(".")[-1] == j.dtype.name, name
            _close_state(t, j, dt, name)
    G = layers // cfg.hybrid_attn_every
    assert tuple(tc["shared_k"].shape) == (G, 3, cfg.num_kv_heads, 16,
                                           cfg.hd)


def test_init_cache_and_layer_views_match_reference():
    cfg, _, tp = _setup("bfloat16", 5)
    jc = jlm.init_cache(cfg, 3, 32)
    tc = tlm.init_cache(cfg, 3, 32, device="cpu")
    assert set(tc) == set(jc)
    for (name, t), (_, j) in zip(_flat(tc), _flat(jc)):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).split(".")[-1] == j.dtype.name, name
        assert not t.any()
    views = tlm.layer_views(tp)
    assert len(views) == cfg.num_layers
    gb, tb = tp["gblocks"]["in_proj"], tp["tail_blocks"]["in_proj"]
    assert views[3]["in_proj"].data_ptr() == gb[1, 1].data_ptr()
    assert views[4]["in_proj"].data_ptr() == tb[0].data_ptr()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decode_step_slots_in_place(dt):
    cfg, jp, tp = _setup(dt, 5)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    _, jc = j_prefill(cfg, jp, jnp.asarray(toks), max_len=16)
    jstate = {k: v for k, v in jc.items() if k != "pos"}
    tstate = _state(jc)
    leaves = dict(_flat(tstate))
    tok = np.array([3, 7, 9], np.int32)
    pos = np.array([6, 2, 11], np.int32)
    jl, jstate = j_step_slots(cfg, jp, jstate, jnp.asarray(tok),
                              jnp.asarray(pos))
    tl, out = tlm.decode_step_slots(cfg, tp, tstate, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
    assert out is tstate
    assert_close(tl, jl, LOGIT_TOL[dt], "slot decode logits")
    for (name, t), (_, j) in zip(_flat(out), _flat(jstate)):
        assert t is leaves[name], f"{name} not updated in place"
        _close_state(t, j, dt, name)


def test_decode_chunk_slots_tokens():
    """fp32 compute: the chunk program's greedy tokens and carry equal the
    reference's, with one row inactive (rem 0) and one finishing early."""
    cfg, jp, tp = _setup("float32", 5)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 9)) \
        .astype(np.int32)
    _, jc = j_prefill(cfg, jp, jnp.asarray(toks), max_len=16)
    carry = (np.array([9, 9, 9], np.int32), np.array([5, 1, 2], np.int32),
             np.array([6, 0, 2], np.int32))
    jst, jcar, jt = jlm.decode_chunk_slots(
        cfg, jp, {k: v for k, v in jc.items() if k != "pos"},
        tuple(jnp.asarray(c) for c in carry), 6)
    tst, tcar, tt = tlm.decode_chunk_slots(
        cfg, tp, _state(jc), tuple(torch.from_numpy(c) for c in carry), 6)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, 6)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for a, b in zip(tcar, jcar):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for (name, t), (_, j) in zip(_flat(tst), _flat(jst)):
        _close_state(t, j, "float32", f"{name} after the chunk")


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompts_match_token_by_token_decode(S):
    cfg, jp, tp = _setup("float32", 5)
    prompt = np.array([17, 401][:S], np.int32)
    # oracle: the reference's decode_step through the prompt from zeros,
    # then greedy
    cache = jlm.init_cache(cfg, 1, 16)
    for t in prompt:
        jl, cache = j_decode_step(cfg, jp, cache, jnp.asarray([t]))
    want, jlogits = [], []
    for _ in range(5):
        jlogits.append(np.asarray(jl))
        tok = int(jnp.argmax(jl, -1)[0])
        want.append(tok)
        jl, cache = j_decode_step(cfg, jp, cache, jnp.asarray([tok]))
    tl, tc = tlm.prefill(cfg, tp, torch.from_numpy(prompt[None]), max_len=16)
    assert tuple(tc["g_ssm"][0].shape[-2:]) == (
        cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    state = {k: v for k, v in tc.items() if k != "pos"}
    got = []
    for i in range(5):
        assert_close(tl, jlogits[i], LOGIT_TOL["float32"], f"logits {i}")
        tok = int(torch.argmax(tl, -1)[0])
        got.append(tok)
        tl, state = tlm.decode_step_slots(
            cfg, tp, state, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([S + i], dtype=torch.int32))
    assert got == want

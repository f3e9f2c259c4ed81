"""The port's Mamba1 serving entry points against ``repro.models.lm`` on
the falcon-mamba smoke config, with the reference's own weights
(PRNGKey(0)) carried over by ``from_reference``.

* ``prefill`` (SSM branch): logits and the per-layer ``(conv, h)`` state;
* ``init_cache``: the reference's SSM cache shapes and dtypes;
* ``decode_step_slots`` at per-row positions, state updated in place;
* ``decode_chunk_slots``: greedy tokens and carry;
* 1- and 2-token prompts, shorter than the conv window: the oracle is the
  reference's ``decode_step`` fed the prompt token by token from
  ``init_cache`` (the reference's own prefill returns a short conv tail
  that its decode cannot continue from).

Tolerances: float32 compute — logits 1e-4 absolute, state 2e-5, identical
greedy tokens (the reference's chunked associative scan and the port's
sequential scan sum in different orders); bfloat16 compute — logits 3e-2
absolute, state 3e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.models import lm as tlm
from test_torch_parity import assert_close, ref_params, smoke_cfg, to_torch

ARCH = "falcon-mamba-7b"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
STATE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _setup(dt):
    cfg = smoke_cfg(ARCH, dt)
    jp, tp = ref_params(cfg)
    return cfg, jp, tp


def _state(cache):
    return {"ssm": tuple(to_torch(np.asarray(a)) for a in cache["ssm"])}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_prefill_logits_and_state(dt):
    cfg, jp, tp = _setup(dt)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 11)) \
        .astype(np.int32)
    lp = np.array([10, 4, 7], np.int32)
    for last in (None, lp):
        jl, jc = jlm.prefill(cfg, jp, jnp.asarray(toks),
                             last_positions=None if last is None
                             else jnp.asarray(last))
        tl, tc = tlm.prefill(cfg, tp, torch.from_numpy(toks),
                             last_positions=None if last is None
                             else torch.from_numpy(last))
        assert tl.dtype == torch.float32 and tc["pos"] == 11
        assert_close(tl, jl, LOGIT_TOL[dt], "prefill logits")
        (jconv, jh), (tconv, th) = jc["ssm"], tc["ssm"]
        assert tconv.dtype == getattr(torch, dt) and th.dtype == torch.float32
        assert_close(tconv, jconv, STATE_TOL[dt], "conv tails")
        assert_close(th, jh, STATE_TOL[dt], "ssm states")
    # the plain scan impl is the same function on CPU tensors
    pl, _ = tlm.prefill(cfg, tp, torch.from_numpy(toks), impl="plain")
    assert torch.equal(pl, tlm.prefill(cfg, tp, torch.from_numpy(toks))[0])


def test_init_cache_matches_reference_shapes():
    cfg = smoke_cfg(ARCH)
    jc = jlm.init_cache(cfg, 3, 32)
    tc = tlm.init_cache(cfg, 3, 32, device="cpu")
    assert set(tc) == set(jc) == {"pos", "ssm"}
    for t, j in zip(tc["ssm"], jc["ssm"]):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == j.dtype.name
        assert not t.any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decode_step_slots_in_place(dt):
    cfg, jp, tp = _setup(dt)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 6)).astype(np.int32)
    _, jc = jlm.prefill(cfg, jp, jnp.asarray(toks))
    jstate = {"ssm": jc["ssm"]}
    tstate = _state(jc)
    conv, h = tstate["ssm"]
    tok = np.array([3, 7, 9], np.int32)
    pos = np.array([6, 2, 11], np.int32)
    jl, jstate = jlm.decode_step_slots(cfg, jp, jstate, jnp.asarray(tok),
                                       jnp.asarray(pos))
    tl, out = tlm.decode_step_slots(cfg, tp, tstate, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
    assert out is tstate and out["ssm"][0] is conv and out["ssm"][1] is h
    assert_close(tl, jl, LOGIT_TOL[dt], "slot decode logits")
    assert_close(conv, jstate["ssm"][0], STATE_TOL[dt], "conv buffers")
    assert_close(h, jstate["ssm"][1], STATE_TOL[dt], "ssm states")


def test_decode_chunk_slots_tokens():
    """fp32 compute: the chunk program's greedy tokens and carry equal the
    reference's, with one row inactive (rem 0) and one finishing early."""
    cfg, jp, tp = _setup("float32")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 9)) \
        .astype(np.int32)
    _, jc = jlm.prefill(cfg, jp, jnp.asarray(toks))
    carry = (np.array([9, 9, 9], np.int32), np.array([5, 1, 2], np.int32),
             np.array([6, 0, 2], np.int32))
    jst, jcar, jt = jlm.decode_chunk_slots(
        cfg, jp, {"ssm": jc["ssm"]}, tuple(jnp.asarray(c) for c in carry), 6)
    tst, tcar, tt = tlm.decode_chunk_slots(
        cfg, tp, _state(jc), tuple(torch.from_numpy(c) for c in carry), 6)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, 6)
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for a, b in zip(tcar, jcar):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert_close(tst["ssm"][1], jst["ssm"][1], STATE_TOL["float32"],
                 "states after the chunk")


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompts_match_token_by_token_decode(S):
    cfg, jp, tp = _setup("float32")
    prompt = np.array([17, 401][:S], np.int32)
    # oracle: the reference's decode_step through the prompt from zeros,
    # then greedy
    cache = jlm.init_cache(cfg, 1, 0)
    for t in prompt:
        jl, cache = jlm.decode_step(cfg, jp, cache, jnp.asarray([t]))
    want, jlogits = [], []
    for _ in range(5):
        jlogits.append(np.asarray(jl))
        tok = int(jnp.argmax(jl, -1)[0])
        want.append(tok)
        jl, cache = jlm.decode_step(cfg, jp, cache, jnp.asarray([tok]))
    tl, tc = tlm.prefill(cfg, tp, torch.from_numpy(prompt[None]))
    assert tuple(tc["ssm"][0].shape[2:]) == (cfg.ssm_conv - 1, cfg.d_inner)
    state = {"ssm": tc["ssm"]}
    got = []
    for i in range(5):
        assert_close(tl, jlogits[i], LOGIT_TOL["float32"], f"logits {i}")
        tok = int(torch.argmax(tl, -1)[0])
        got.append(tok)
        tl, state = tlm.decode_step_slots(
            cfg, tp, state, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([S + i], dtype=torch.int32))
    assert got == want


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internvl2-1b",
                                  "musicgen-large"])
def test_slot_entry_points_refuse_unported_archs(arch):
    cfg = smoke_cfg(arch)
    # MoE and the frontend archs are attention archs: init_cache gives
    # their contiguous KV cache, the slot entry points refuse them
    assert set(tlm.init_cache(cfg, 1, 8, device="cpu")) \
        == {"pos", "k", "v"}
    with pytest.raises(ValueError):
        tlm.decode_step_slots(cfg, {}, None, None, None)
    with pytest.raises(ValueError):
        tlm.decode_chunk_slots(cfg, {}, None, None, 1)


def test_slot_entry_points_refuse_attention_archs():
    cfg = smoke_cfg("stablelm-1.6b")
    with pytest.raises(ValueError, match="page their KV"):
        tlm.decode_step_slots(cfg, {}, None, None, None)
    # init_cache has the reference's attention branch (the contiguous cache
    # of the per-call baseline), not the slot state
    cache = tlm.init_cache(cfg, 1, 8, device="cpu")
    assert set(cache) == {"pos", "k", "v"}
    assert tuple(cache["k"].shape) == (cfg.num_layers, 1, cfg.num_kv_heads,
                                       8, cfg.hd)

"""The port's ServeEngine on zamba2 (the Mamba2 + shared-attention hybrid,
the slot-state path) against the reference.

Under float32 compute, with the reference's own weights, the port's engine
on the CPU must emit EXACTLY the greedy tokens of

* the JAX engine (its resident slot-state pipeline) for the prompts of the
  reference's ``test_ssm_and_hybrid_serve_resident`` plus one prompt
  submitted mid-decode, and of the JAX contiguous decode (``prefill`` +
  ``decode_step``) for the same prompts (in bf16 the contiguous decode
  flips near-ties against the engine, which is why the reference fails its
  own test; fp32 agrees);
* the same two for a request with ``prompt + max_new == max_seq_len``: its
  last decode steps write K and V at the span's final position, and an
  inactive row keeps stepping there without running past it (torch's
  index write would raise where JAX's scatter drops the index);
* the JAX ``decode_step`` fed the prompt token by token from
  ``init_cache`` for 1- and 2-token prompts, which are shorter than the
  conv window (the JAX engine fails those rows: its conv tail has fewer
  than K-1 rows).

Every slot is free at the end, and ``prompt + max_new > max_seq_len`` is
refused at submit as in the reference. The JAX tokens are built once per
module.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.launch import serve as launcher
from repro_torch.params import from_reference
from repro_torch.serve.engine import ServeEngine

MAX_NEW = 12
GEOM = dict(decode_chunk=2, max_seq_len=64, max_batch=4)
PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(2, 10, dtype=np.int32),
           np.arange(4, 9, dtype=np.int32)]
LATE = np.array([40, 7, 311, 2, 95, 18, 260], np.int32)   # mid-decode
# prompt + MAX_NEW == max_seq_len exactly
EXACT = ((np.arange(64 - MAX_NEW) * 37 + 11) % 503).astype(np.int32)

j_prefill = jax.jit(jlm.prefill, static_argnums=(0,),
                    static_argnames=("max_len",))
j_decode_step = jax.jit(jlm.decode_step, static_argnums=(0,))


@pytest.fixture(scope="module")
def fp32_setup():
    cfg = dataclasses.replace(get_config("zamba2-1.2b").smoke(),
                              compute_dtype="float32")
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                        device="cpu")
    return cfg, jp, tp


def _contiguous(cfg, jp, prompt, max_new):
    """Greedy decode through the reference's contiguous cache."""
    logits, cache = j_prefill(cfg, jp, jnp.asarray(prompt[None]),
                              max_len=len(prompt) + max_new)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [int(tok[0])]
    for _ in range(max_new - 1):
        logits, cache = j_decode_step(cfg, jp, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(int(tok[0]))
    return out


def _token_by_token(cfg, jp, prompt, max_new):
    """The reference's decode_step fed the prompt from init_cache, then
    greedy: needs no conv tail from a prefill."""
    cache = jlm.init_cache(cfg, 1, len(prompt) + max_new)
    for t in prompt:
        logits, cache = j_decode_step(cfg, jp, cache,
                                      jnp.asarray([t], jnp.int32))
    out = []
    for _ in range(max_new):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(int(tok[0]))
        logits, cache = j_decode_step(cfg, jp, cache, tok)
    return out


@pytest.fixture(scope="module")
def jax_reference(fp32_setup):
    cfg, jp, _ = fp32_setup
    prompts = PROMPTS + [LATE, EXACT]
    with JEngine(cfg, jp, **GEOM) as eng:
        assert not eng.paged
        engine = [o.tolist() for o in eng.generate(prompts, MAX_NEW)]
    contiguous = [_contiguous(cfg, jp, p, MAX_NEW) for p in prompts]
    return engine, contiguous


def _all_slots_free(eng) -> bool:
    return len(eng._free_slots) == len(eng._slot_req) \
        and eng._slots_reserved == 0 and not eng._inflight \
        and all(r is None for r in eng._slot_req)


def test_tokens_identical_to_jax_engine_and_contiguous_decode(
        fp32_setup, jax_reference):
    cfg, _, tp = fp32_setup
    engine, contiguous = jax_reference
    with ServeEngine(cfg, tp, device="cpu", record_stages=True,
                     **GEOM) as eng:
        assert not eng.paged
        assert set(eng._sstate) == {"g_ssm", "tail_ssm", "shared_k",
                                    "shared_v"}
        reqs = [eng.submit(p, max_new=MAX_NEW) for p in PROMPTS]
        deadline = time.perf_counter() + 60
        while reqs[0].first_token_at is None \
                and time.perf_counter() < deadline:
            time.sleep(0.001)
        late = eng.submit(LATE, max_new=MAX_NEW)     # mid-decode
        outs = [eng.result(r, timeout=120).tolist() for r in reqs + [late]]
        stats = dict(eng.stats)
        assert _all_slots_free(eng)
    assert outs == engine[:4]
    assert outs == contiguous[:4]
    # the late request joined while the first ones were still decoding
    assert late.admitted_at < max(r.finished_at for r in reqs)
    assert stats["prefills"] == stats["retired"] == 4
    assert stats["tokens_out"] == 4 * (MAX_NEW - 1)
    assert stats["prefill_windows"] == stats["grown_blocks"] == 0


def test_exact_fit_request_matches_reference(fp32_setup, jax_reference):
    """prompt + max_new == max_seq_len: served beside shorter rows, whose
    slots go inactive and keep stepping at their final positions."""
    cfg, _, tp = fp32_setup
    engine, contiguous = jax_reference
    assert len(EXACT) + MAX_NEW == GEOM["max_seq_len"]
    with ServeEngine(cfg, tp, device="cpu", **GEOM) as eng:
        got = [o.tolist() for o in eng.generate([EXACT] + PROMPTS[:2],
                                                MAX_NEW)]
        assert _all_slots_free(eng)
    assert got[0] == engine[4] == contiguous[4]
    assert got[1:] == engine[:2]


def test_short_prompts_match_token_by_token_decode(fp32_setup):
    cfg, jp, tp = fp32_setup
    prompts = [np.array([17], np.int32), np.array([17, 401], np.int32),
               np.array([5, 9, 2], np.int32)]
    want = [_token_by_token(cfg, jp, p, 6) for p in prompts]
    with ServeEngine(cfg, tp, device="cpu", **GEOM) as eng:
        got = [o.tolist() for o in eng.generate(prompts, max_new=6)]
        assert _all_slots_free(eng)
    assert got == want


def test_max_seq_len_refused_as_in_reference(fp32_setup):
    cfg, jp, tp = fp32_setup
    prompt = np.arange(1, 61, dtype=np.int32)
    with ServeEngine(cfg, tp, device="cpu", **GEOM) as eng, \
            JEngine(cfg, jp, **GEOM) as jeng:
        for e in (eng, jeng):
            with pytest.raises(ValueError, match="max_seq_len 64"):
                e.submit(prompt, max_new=5)
    with ServeEngine(cfg, tp, device="cpu") as eng:
        assert eng._max_seq == 512       # the reference's slot default
        assert eng._sstate["shared_k"].shape[3] == 512


def test_launcher_serves_zamba2_on_cpu(capsys):
    launcher.main(["--arch", "zamba2-1.2b", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "6", "--max-new", "4",
                   "--max-seq-len", "32"])
    out = capsys.readouterr().out
    assert "zamba2-1.2b-smoke" in out and "tok/s" in out
    assert "'prefills': 2" in out

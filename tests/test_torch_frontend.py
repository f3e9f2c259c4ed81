"""The modality-frontend archs in the port (musicgen-large: audio frames,
sinusoidal positions, a plain GELU MLP; internvl2-1b: image patches, GQA
with a QKV bias, tied embeddings) against ``repro.models.lm``, with the
reference's own weights (PRNGKey(0)) carried over by ``from_reference``
and the same seeded ``frontend_embeds`` (B, F, D) fed to both:

* ``forward`` logits over the F + S positions; ``loss_fn``'s terms (the
  F-offset loss) and, in fp32, every leaf's gradient;
* ``prefill``: logits and the cache (k, v and ``pos`` = F + S), with a
  ``max_len`` beyond it; ``decode_step`` for three steps after it;
* ``last_positions`` with a frontend is refused, as in the reference;
* the port's counterpart of ``tests/test_models_smoke.py``'s three
  per-arch tests over every arch of ``repro_torch.configs.ARCHS``: the
  forward's shape and finiteness, a finite loss with a nonzero gradient,
  and prefill-then-decode against the teacher-forced forward (the
  reference test's own bounds);
* the port's ``Trainer`` on internvl2-1b's smoke config, as
  ``tests/test_trainer.py``.

Tolerances: fp32 compute — logits 1e-4 absolute, the cache 2e-5, loss
terms 1e-5 relative, gradients 1e-4 of each leaf's largest magnitude;
bf16 compute — logits 3e-2 absolute, loss terms 2e-3 relative (as
``tests/test_torch_lm.py`` and ``tests/test_torch_train_step.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import lm as tlm
from repro_torch.optim import OptConfig
from repro_torch.params import from_reference, init_params
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.tree import leaves
from test_torch_parity import assert_close, smoke_cfg, to_np

FRONTEND = ("musicgen-large", "internvl2-1b")
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
CACHE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
LOSS_REL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_REL = 1e-4
B, S = 2, 12

j_forward = jax.jit(jlm.forward, static_argnums=(0,))
j_prefill = jax.jit(jlm.prefill, static_argnums=(0,),
                    static_argnames=("max_len",))
j_decode_step = jax.jit(jlm.decode_step, static_argnums=(0,))


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        smoke_cfg(arch, "float32"), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _setup(arch, dt):
    cfg = smoke_cfg(arch, dt)
    tree = _ref_tree(arch)
    return (cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            from_reference(tree, cfg, device="cpu", cast=False))


def _inputs(cfg, seq=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, seq)).astype(np.int32)
    fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)
                             ).astype(np.float32)
    return toks, fe


def _rel_close(a, b, rel, what):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= rel * max(scale, 1e-30), \
        f"{what}: max abs err {err} > {rel} x {scale}"


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND)
def test_forward_and_loss_match_reference(arch, dt):
    cfg, jp, tp = _setup(arch, dt)
    toks, fe = _inputs(cfg)
    F = cfg.frontend_tokens
    jbatch = {"tokens": jnp.asarray(toks), "frontend_embeds": jnp.asarray(fe)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "frontend_embeds": torch.from_numpy(fe)}
    jl, _ = j_forward(cfg, jp, jbatch["tokens"], jbatch["frontend_embeds"])
    with torch.no_grad():
        tl, taux = tlm.forward(cfg, tp, tbatch["tokens"],
                               tbatch["frontend_embeds"])
    assert tuple(tl.shape) == (B, F + S, cfg.padded_vocab)
    assert_close(tl, jl, LOGIT_TOL[dt], "logits")
    assert float(taux) == 0.0

    def ref(p):
        return jlm.loss_fn(cfg, p, jbatch)
    if dt == "float32":
        (jtot, jmet), jg = jax.jit(jax.value_and_grad(ref, has_aux=True))(jp)
    else:
        jtot, jmet = jax.jit(ref)(jp)
    flat = [t.requires_grad_(True) for t in leaves(tp)]
    ttot, tmet = tlm.loss_fn(cfg, tp, tbatch)
    _rel_close(ttot, jtot, LOSS_REL[dt], "total loss")
    for k in ("ce", "zloss"):
        _rel_close(tmet[k], jmet[k], LOSS_REL[dt], k)
    if dt != "float32":
        return
    tg = torch.autograd.grad(ttot, flat)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jg)]
    jflat = jax.tree_util.tree_leaves(jg)
    assert len(jflat) == len(tg)
    for name, g_t, g_j in zip(paths, tg, jflat):
        _rel_close(g_t, g_j, GRAD_REL, f"grad {name}")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND)
def test_prefill_and_decode_match_reference(arch, dt):
    cfg, jp, _ = _setup(arch, dt)
    tree = _ref_tree(arch)
    tp = from_reference(tree, cfg, device="cpu")
    toks, fe = _inputs(cfg, seed=1)
    F = cfg.frontend_tokens
    max_len = F + S + 5
    jl, jc = j_prefill(cfg, jp, jnp.asarray(toks), max_len=max_len,
                       frontend_embeds=jnp.asarray(fe))
    with torch.no_grad():
        tl, tc = tlm.prefill(cfg, tp, torch.from_numpy(toks), max_len,
                             frontend_embeds=torch.from_numpy(fe))
        assert int(tc["pos"]) == int(jc["pos"]) == F + S
        assert_close(tl, jl, LOGIT_TOL[dt], "prefill logits")
        for k in ("k", "v"):
            assert tuple(tc[k].shape) == jc[k].shape
            assert_close(tc[k], jc[k], CACHE_TOL[dt], f"cache {k}")
        cur = np.argmax(np.asarray(jl), -1).astype(np.int32)
        for i in range(3):
            jl, jc = j_decode_step(cfg, jp, jc, jnp.asarray(cur))
            tl, tc = tlm.decode_step(cfg, tp, tc, torch.from_numpy(cur))
            assert int(tc["pos"]) == int(jc["pos"]) == F + S + i + 1
            assert_close(tl, jl, LOGIT_TOL[dt], f"decode step {i}")
            cur = np.argmax(np.asarray(jl), -1).astype(np.int32)


@pytest.mark.parametrize("arch", FRONTEND)
def test_frontend_refusals_match_reference(arch):
    """``last_positions`` would index the concatenated sequence: refused
    with a frontend, by both; a frontend arch without its frames is
    refused, by both; the paged entry points never take a frontend."""
    cfg, jp, tp = _setup(arch, "float32")
    toks, fe = _inputs(cfg)
    last = np.full((B,), S - 1, np.int32)
    with pytest.raises(ValueError, match="last_positions"):
        jlm.prefill(cfg, jp, jnp.asarray(toks), frontend_embeds=jnp.asarray(
            fe), last_positions=jnp.asarray(last))
    with pytest.raises(ValueError, match="last_positions"):
        tlm.prefill(cfg, tp, torch.from_numpy(toks),
                    frontend_embeds=torch.from_numpy(fe),
                    last_positions=torch.from_numpy(last))
    with pytest.raises(ValueError, match="requires frontend_embeds"):
        jlm.forward(cfg, jp, jnp.asarray(toks))
    with pytest.raises(ValueError, match="requires frontend_embeds"):
        tlm.forward(cfg, tp, torch.from_numpy(toks))
    with pytest.raises(ValueError, match="without a frontend"):
        tlm.prefill_window_paged(cfg, tp, None, None, torch.from_numpy(toks),
                                 None, None, None)


# --------------------------- the port's counterpart of test_models_smoke.py
def _smoke_batch(cfg, Bb=2, Ss=32, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (Bb, Ss)).astype(np.int32))}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
            (Bb, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _smoke_params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       cast=False)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_shapes_and_finite(arch):
    cfg = get_config(arch).smoke()
    batch = _smoke_batch(cfg)
    with torch.no_grad():
        logits, aux = tlm.forward(cfg, _smoke_params(cfg), batch["tokens"],
                                  batch.get("frontend_embeds"))
    F = cfg.frontend_tokens if cfg.frontend != "none" else 0
    assert tuple(logits.shape) == (2, 32 + F, cfg.padded_vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_no_nans(arch):
    cfg = get_config(arch).smoke()
    params = _smoke_params(cfg)
    flat = [t.requires_grad_(True) for t in leaves(params)]
    loss, _ = tlm.loss_fn(cfg, params, _smoke_batch(cfg))
    assert torch.isfinite(loss)
    grads = torch.autograd.grad(loss, flat)
    gn = sum(float(torch.sum(torch.square(g.float()))) for g in grads)
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_decode_matches_forward(arch):
    cfg = get_config(arch).smoke()
    params = _smoke_params(cfg)
    Ss = 24
    batch = _smoke_batch(cfg, 2, Ss)
    fe = batch.get("frontend_embeds")
    F = cfg.frontend_tokens if cfg.frontend != "none" else 0
    with torch.no_grad():
        full, _ = tlm.forward(cfg, params, batch["tokens"], fe)
        # room for the frames too: the reference test's max_len = S + 4
        # leaves a frontend arch's decode write past the cache, where
        # JAX's update clamps it onto the last entry and torch raises
        lp, cache = tlm.prefill(cfg, params, batch["tokens"][:, :Ss - 1],
                                max_len=F + Ss + 4, frontend_embeds=fe)
        ref = full[:, F + Ss - 2]
        scale = float(ref.abs().max()) + 1e-6
        err = float((lp - ref).abs().max()) / scale
        assert err < 2e-2, f"prefill mismatch {err}"
        ld, cache2 = tlm.decode_step(cfg, params, cache,
                                     batch["tokens"][:, Ss - 1])
        ref2 = full[:, F + Ss - 1]
        p1 = torch.softmax(ld[:, :cfg.vocab_size], dim=-1)
        p2 = torch.softmax(ref2[:, :cfg.vocab_size], dim=-1)
        perr = float((p1 - p2).abs().max())
        assert perr < 5e-3, f"decode distribution mismatch {perr}"
        assert int(cache2["pos"]) == int(cache["pos"]) + 1


def test_trainer_runs_and_checkpoints_a_frontend_arch(tmp_path):
    cfg = get_config("internvl2-1b").smoke()
    tc = TrainerConfig(total_steps=6, ckpt_every=3, log_every=2,
                       microbatches=2)
    tr = Trainer(cfg, tc, batch=2, seq_len=32,
                 opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=6),
                 ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    assert "frontend_embeds" in tr.data.batch_at(0)
    out = tr.run()
    assert out["state"]["step"] == 6
    assert out["restarts"] == 0
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert tr.ckpt.latest_step() == 6

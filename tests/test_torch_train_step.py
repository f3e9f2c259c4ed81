"""The port's training forward, loss, gradients and train step against
``repro.models.lm`` / ``repro.train.train_step`` on the smoke configs of
stablelm-1.6b (MHA), qwen3-14b (GQA with qk_norm) and qwen2-moe-a2.7b (MoE,
router aux loss), with the reference's own fp32 weights (PRNGKey(0))
carried over by ``from_reference(cast=False)``.

Tolerances, measured on these inputs with a margin:

* fp32 compute: logits within 1e-5 of their largest magnitude; the loss
  terms (total, ce, zloss, aux) within 1e-5 relative; every gradient leaf
  within 1e-4 of that leaf's largest magnitude;
* bf16 compute (activations rounded at other places by XLA and PyTorch):
  logits within 3e-2 of their largest magnitude, the loss terms within
  2e-3 relative;
* one whole train step (AdamW, fp32): the moments and the metrics within
  1e-5 relative to each leaf's largest magnitude; the new params within
  5e-2 x lr absolute. The first AdamW step moves a weight by lr x g / (|g|
  + eps), which is ill-conditioned where |g| is near eps = 1e-8: there a
  gradient that agrees to 1e-6 relative still moves the weight by a few
  hundredths of lr more or less (measured: at most 3.1e-5 = 0.031 lr).

Measured on these inputs: fp32 logits 1.1e-6, loss terms 3e-7 and
gradients 1.5e-6 relative; bf16 logits 1.3e-2 and loss terms 2.6e-4.

S = 32 takes the chunked-attention branch (attn_chunk_q = 16), S = 21 the
ragged one (one full attention). The JAX functions are jitted, one XLA
program per case.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import ShardCtx
from repro.models import lm as jlm
from repro.optim.adamw import OptConfig as JOptConfig
from repro.optim.adamw import init_opt_state as j_init_opt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.models import lm as tlm
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.params import from_reference
from repro_torch.train.train_step import make_train_step, split_microbatches
from repro_torch.tree import leaves
from test_torch_parity import smoke_cfg, to_np

ARCHS = ("stablelm-1.6b", "qwen3-14b", "qwen2-moe-a2.7b")
LOGIT_REL = {"float32": 1e-5, "bfloat16": 3e-2}
LOSS_REL = {"float32": 1e-5, "bfloat16": 2e-3}
GRAD_REL = 1e-4
STEP_REL = 1e-5
PARAM_STEP_LR = 5e-2
B = 2


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        smoke_cfg(arch), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _setup(arch, dt):
    cfg = smoke_cfg(arch, dt)
    tree = _ref_tree(arch)
    return (cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            from_reference(tree, cfg, device="cpu", cast=False))


def _tokens(cfg, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _rel_close(a, b, rel, what):
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= rel * max(scale, 1e-30), \
        f"{what}: max abs err {err} > {rel} x {scale}"


LOSS_KEYS = ("ce", "zloss", "aux")


@pytest.mark.parametrize("S", [32, 21])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, dt, S):
    cfg, jp, tp = _setup(arch, dt)
    toks = _tokens(cfg, S)
    batch_j = {"tokens": jnp.asarray(toks)}
    batch_t = {"tokens": torch.from_numpy(toks)}
    with_grads = dt == "float32"

    def ref(p, b):
        logits, aux = jlm.forward(cfg, p, b["tokens"])
        if with_grads:
            return logits, aux, jax.value_and_grad(
                lambda q: jlm.loss_fn(cfg, q, b), has_aux=True)(p)
        return logits, aux, (jlm.loss_fn(cfg, p, b), None)

    jl, jaux, ((jtot, jmet), jg) = jax.jit(ref)(jp, batch_j)

    with torch.no_grad():
        tl, taux = tlm.forward(cfg, tp, batch_t["tokens"])
    assert tl.dtype == torch.float32
    assert tuple(tl.shape) == (B, S, cfg.padded_vocab)
    _rel_close(tl, jl, LOGIT_REL[dt], "logits")
    flat = [t.requires_grad_(True) for t in leaves(tp)]
    ttot, tmet = tlm.loss_fn(cfg, tp, batch_t)
    _rel_close(ttot, jtot, LOSS_REL[dt], "total loss")
    for k in LOSS_KEYS:
        if cfg.moe or k != "aux":
            _rel_close(tmet[k], jmet[k], LOSS_REL[dt], k)
    if not cfg.moe:
        assert float(tmet["aux"]) == 0.0 == float(jmet["aux"])
    _rel_close(tmet["ppl_proxy"], jmet["ppl_proxy"], 2 * LOSS_REL[dt],
               "ppl_proxy")
    if not with_grads:
        return
    tg = torch.autograd.grad(ttot, flat)
    jflat = jax.tree_util.tree_leaves(jg)
    assert len(jflat) == len(tg)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jg)]
    for name, g_t, g_j in zip(paths, tg, jflat):
        _rel_close(g_t, g_j, GRAD_REL, f"grad {name}")


def _jax_step(cfg, opt, mb):
    fn, _, _ = j_make_train_step(cfg, ShardCtx(mesh=None), opt,
                                 microbatches=mb)
    return jax.jit(fn)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, mb):
    cfg, jp, tp = _setup(arch, "float32")
    toks = _tokens(cfg, 32, seed=1)
    jopt = JOptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    jst = j_init_opt(jp, jopt)
    tst = init_opt_state(tp, opt)
    jp2, jst2, jm = _jax_step(cfg, jopt, mb)(
        jp, jst, {"tokens": jnp.asarray(toks)})
    step = make_train_step(cfg, opt, microbatches=mb)
    tp2, tst2, tm = step(tp, tst, {"tokens": torch.from_numpy(toks)})
    assert set(tm) == set(jm)
    for k in jm:
        _rel_close(tm[k], jm[k], STEP_REL, f"metric {k}")
    assert int(tst2["count"]) == int(jst2["count"]) == 1
    for what, t, j in (("params", tp2, jp2), ("m", tst2["m"], jst2["m"]),
                       ("v", tst2["v"], jst2["v"])):
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_leaves_with_path(j)]
        for name, a, b in zip(paths, leaves(t), jax.tree_util.tree_leaves(j)):
            if what == "params":
                err = float(np.max(np.abs(to_np(a) - to_np(b))))
                assert err <= PARAM_STEP_LR * opt.lr, (name, err)
            else:
                _rel_close(a, b, STEP_REL, f"{what} {name}")


def test_train_step_with_compression_composes_its_parts():
    """``compress=True``: the step's update is AdamW on
    ``compress_grads`` of the loss gradients, with the new error state in
    ``opt_state["err"]`` (each part is held against the reference in
    ``tests/test_torch_optim.py``)."""
    from repro_torch.optim import adamw_update, compress_grads
    from repro_torch.optim import init_error_state
    from repro_torch.tree import tree_map, unflatten
    cfg, _, tp = _setup("stablelm-1.6b", "float32")
    toks = torch.from_numpy(_tokens(cfg, 32, seed=2))
    opt = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    ref = tree_map(torch.clone, tp)
    st = dict(init_opt_state(tp, opt), err=init_error_state(tp))
    tp2, st2, m = make_train_step(cfg, opt, compress=True, microbatches=1)(
        tp, st, {"tokens": toks})
    flat = [t.requires_grad_(True) for t in leaves(ref)]
    total, _ = tlm.loss_fn(cfg, ref, {"tokens": toks})
    grads = unflatten(ref, list(torch.autograd.grad(total, flat)))
    for t in flat:
        t.requires_grad_(False)
    grads, err = compress_grads(grads, init_error_state(ref))
    want, wst, wm = adamw_update(ref, grads, init_opt_state(ref, opt), opt)
    assert float(m["grad_norm"]) == float(wm["grad_norm"])
    for a, b in zip(leaves(tp2), leaves(want)):
        assert torch.equal(a, b)
    for a, b in zip(leaves(st2["err"]), leaves(err)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_microbatch_rule_matches_reference():
    assert split_microbatches(8, None) == 8      # one sequence each
    assert split_microbatches(8, 1) == 1
    assert split_microbatches(6, 4) == 3         # steps down to a divisor
    assert split_microbatches(7, 2) == 1

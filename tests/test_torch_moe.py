"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the qwen2-moe (shared experts, top-k not
renormalised) and arctic (dense residual, top-k renormalised) smoke
configs, with the reference's own layer weights (``init_moe`` at PRNGKey(1))
carried over by ``from_reference``.

Cases: the config as published (capacity factor 1.25), a capacity factor
of 0.25 that drops assignments over capacity, and 3 inert padded experts
(``moe_expert_pad``), each in float32 and bfloat16 compute, on T = 64
tokens of seeded numpy input.

* Routing: the experts chosen and the dropped assignments agree EXACTLY in
  float32 (the router's product and softmax are fp32 in both; on a
  mismatch the assertion reports the top-k gap, the margin between the
  k-th and (k+1)-th probabilities of the first token that differs).
* Output: float32 2e-5 x max(1, max |reference|); bfloat16 2e-2 x max(1,
  max |reference|) (a few bf16 ulps: XLA and PyTorch round the expert
  products at different places).
* The load-balancing loss, on request: 1e-5 absolute (fp32 from the same
  probabilities and choices).
* The serving entry points never compute it.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.params import from_reference, init_params
from test_torch_parity import assert_close, smoke_cfg, to_np

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
VARIANTS = {"published": {}, "drops": {"capacity_factor": 0.25},
            "expert_pad": {"moe_expert_pad": 3}}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

j_moe = jax.jit(jmoe.moe_layer, static_argnums=(2,))


def _jax_routing(p, xt, cfg):
    """The reference's routing steps (``repro.models.moe.moe_layer``'s
    first lines): probabilities, top-k experts and each assignment's rank
    among its expert's."""
    E = cfg.num_experts + cfg.moe_expert_pad
    logits = xt.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    if cfg.moe_expert_pad:
        logits = jnp.where(jnp.arange(E) < cfg.num_experts, logits, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    _, eidx = jax.lax.top_k(probs, cfg.num_experts_per_tok)
    flat_e = eidx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    return probs, eidx, jnp.take_along_axis(pos, flat_e[:, None], 1)[:, 0]


j_routing = jax.jit(_jax_routing, static_argnums=(2,))


@functools.lru_cache(maxsize=None)
def _layer_tree(arch, pad):
    """One MoE layer's reference params as numpy (``init_moe``; they
    depend on neither the compute dtype nor the capacity factor)."""
    cfg = dataclasses.replace(smoke_cfg(arch), moe_expert_pad=pad)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jmoe.init_moe, static_argnums=(1,))(jax.random.PRNGKey(1), cfg))


def _setup(arch, dt, variant):
    cfg = dataclasses.replace(smoke_cfg(arch, dt), **VARIANTS[variant])
    tree = _layer_tree(arch, cfg.moe_expert_pad)
    return (cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            from_reference(tree, cfg, device="cpu"))


def _first_mismatch_gap(probs, eidx, teidx, K):
    """The top-k gap of the first token whose chosen experts differ."""
    t = int(np.nonzero((eidx != teidx).any(axis=1))[0][0])
    top = np.sort(probs[t])[::-1]
    return t, float(top[K - 1] - top[K])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_matches_reference(arch, dt, variant):
    cfg, jl, tl = _setup(arch, dt, variant)
    x = np.random.default_rng(0).standard_normal((4, 16, cfg.d_model)) \
        .astype(np.float32)
    xj = jnp.asarray(x).astype(dt)
    xt = torch.from_numpy(x).to(getattr(torch, dt))
    yj, aj = j_moe(jl, xj, cfg)
    y = tmoe.moe_layer(tl, xt, cfg)
    yt, at = tmoe.moe_layer(tl, xt, cfg, return_aux=True)
    assert isinstance(y, torch.Tensor) and torch.equal(y, yt)
    assert yt.dtype == getattr(torch, dt) and tuple(yt.shape) == x.shape
    scale = max(1.0, float(np.abs(to_np(yj)).max()))
    assert_close(yt, yj, TOL[dt] * scale, "moe output")
    assert_close(at, aj, 1e-5, "aux loss")

    probs, eidx, rank = (np.asarray(a) for a in j_routing(
        jl, xj.reshape(-1, cfg.d_model), cfg))
    r = tmoe.route(tl, xt.reshape(-1, cfg.d_model), cfg)
    K = cfg.num_experts_per_tok
    dropped = (r.rank >= r.capacity).numpy()
    if variant == "drops":
        assert dropped.any()
    if variant == "expert_pad":
        assert r.eidx.max() < cfg.num_experts
    if dt == "float32":
        teidx = r.eidx.numpy()
        if not np.array_equal(teidx, eidx):
            t, gap = _first_mismatch_gap(probs, eidx, teidx, K)
            raise AssertionError(f"routing differs at token {t}: top-{K} "
                                 f"gap {gap:.3e}")
        assert np.array_equal(r.rank.numpy(), rank)
        assert_close(r.probs, probs, 1e-6, "router probabilities")


def test_serving_entry_points_never_compute_aux(monkeypatch):
    """The aux loss is skipped where nobody reads it: prefill, the paged
    window and the paged decode step run with ``_aux_loss`` made to fail."""
    cfg = smoke_cfg("qwen2-moe-a2.7b", "float32")
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def boom(*a, **k):
        raise AssertionError("aux loss computed on the serving path")

    monkeypatch.setattr(tmoe, "_aux_loss", boom)
    toks = torch.tensor([[5, 9, 2, 7]], dtype=torch.int32)
    logits, _ = tlm.prefill(cfg, tp, toks)
    pool = torch.zeros((cfg.num_layers, 2, 8, cfg.num_kv_heads, 4, cfg.hd))
    tables = torch.arange(1, 5, dtype=torch.int32)[None]
    first, _ = tlm.prefill_window_paged(
        cfg, tp, pool, tables, toks, torch.tensor([0]),
        torch.ones((1, 4), dtype=torch.bool), torch.tensor([3]))
    step, _ = tlm.decode_step_paged(
        cfg, tp, pool, tables, torch.tensor([4], dtype=torch.int32),
        first, torch.tensor([True]))
    assert int(first[0]) == int(torch.argmax(logits[0]))
    assert tuple(step.shape) == (1, cfg.padded_vocab)

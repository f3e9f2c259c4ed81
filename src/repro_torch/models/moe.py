"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Counterpart of ``repro.models.moe``, on torch tensors. Each (token, expert)
assignment is ranked by the exclusive cumulative count of its expert over
the flattened (T*K) order (the reference's Switch-style ranking, no sort),
assignments ranked at or past the capacity C are dropped, and the kept ones
fill an (E+1, C) slot table whose last row is the sentinel of the dropped.
Then gather -> three batched expert products -> gate-weighted combine.
qwen2-moe adds its sigmoid-gated shared experts, arctic its dense FFN in
parallel with the MoE. The reference's ``constrain``/``_tp_size`` sharding
hooks are identities off a mesh and are dropped.

Three properties the serving path relies on:

* fixed shapes and no host sync: C comes from the input's shape, and the
  dispatch is ``topk``, ``cumsum``, ``scatter_`` and ``index_select`` on
  the device (no boolean-mask indexing, ``nonzero`` or ``.item()``), so a
  decode chunk keeps its one sync;
* a deterministic combine: each token's K contributions are gathered from
  the expert outputs (a dropped one reads a zero sentinel row) and summed
  in ascending expert id in the compute dtype, the order of the
  reference's scatter-add over its (E, C) update rows, never with atomics;
* the router's load-balancing loss is computed only when asked for
  (``return_aux``): the serving call sites never read it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import dense_init, dtype_of, normal_init
from .mlp import mlp

__all__ = ["init_moe", "moe_layer", "route", "Routing"]


def init_moe(generator: torch.Generator, cfg: ModelConfig, device=None,
             cast: bool = True) -> Dict[str, torch.Tensor]:
    """One layer's MoE leaves with the reference ``init_moe``'s names,
    shapes and distributions: ``router`` N(0, 0.02) in fp32; the expert
    matrices ``e_wi``/``e_wg`` (E, D, F) and ``e_wd`` (E, F, D) fan-in
    scaled over every axis but the last, as the reference's
    ``dense_init``; the shared experts' gated MLP and their zero
    ``shared_gate`` (D, 1) in ``param_dtype``; arctic's ``dense_`` MLP.
    Matrices come in the compute dtype (the port's load-time cast; with
    ``cast=False`` in ``param_dtype``, the training masters), drawn on the
    generator's device and moved to ``device`` (None: the generator's).
    """
    g = generator
    dev = g.device if device is None else device
    D, Fe = cfg.d_model, cfg.moe_d_ff
    E = cfg.num_experts + cfg.moe_expert_pad
    pdt = dtype_of(cfg.param_dtype)
    mdt = dtype_of(cfg.compute_dtype) if cast else pdt

    def dense(shape):
        return dense_init(g, shape, mdt).to(dev)

    p = {"router": normal_init(g, (D, E), 0.02, torch.float32).to(dev),
         "e_wi": dense((E, D, Fe)), "e_wg": dense((E, D, Fe)),
         "e_wd": dense((E, Fe, D))}

    def gated_mlp(prefix, d_ff):
        p[prefix + "wi"] = dense((D, d_ff))
        if cfg.mlp_gated:
            p[prefix + "wg"] = dense((D, d_ff))
        p[prefix + "wd"] = dense((d_ff, D))

    if cfg.shared_expert_d_ff:
        gated_mlp("shared_", cfg.shared_expert_d_ff)
        p["shared_gate"] = torch.zeros((D, 1), dtype=pdt, device=dev)
    if cfg.dense_residual:
        gated_mlp("dense_", cfg.d_ff)
    return p


def _capacity(T: int, cfg: ModelConfig) -> int:
    c = int(T * cfg.num_experts_per_tok * cfg.capacity_factor
            / cfg.num_experts) + 1
    return max(8, -(-c // 8) * 8)  # rounded up to 8, as the reference


class Routing(NamedTuple):
    """The router's decision for T tokens: ``probs`` (T, E) fp32, ``gate``
    and ``eidx`` (T, K) (the top-k, descending), ``rank`` (T*K,) each
    assignment's place among its expert's in the flattened order, and the
    ``capacity`` C (assignments with ``rank >= C`` are dropped)."""
    probs: torch.Tensor
    gate: torch.Tensor
    eidx: torch.Tensor
    rank: torch.Tensor
    capacity: int


def route(p, xt: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Router softmax, top-k (renormalised when ``norm_topk_prob``), the
    inert padded experts masked to -1e30, and the exclusive-cumsum rank of
    every assignment. xt: (T, D)."""
    T = xt.shape[0]
    E = cfg.num_experts + cfg.moe_expert_pad
    K = cfg.num_experts_per_tok
    experts = torch.arange(E, device=xt.device)
    logits = xt.float() @ p["router"].float()
    if cfg.moe_expert_pad:
        logits = logits.masked_fill(experts >= cfg.num_experts, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(dim=-1, keepdim=True)
    flat_e = eidx.reshape(-1)
    # the one-hots laid out (E, T*K), so the count runs along the inner
    # axis: a scan over the outer axis is one serial pass down T*K rows on
    # CUDA (0.36 ms a layer at T*K = 2048 on the H100)
    onehot = (experts[:, None] == flat_e).to(torch.int32)
    pos = onehot.cumsum(dim=1, dtype=torch.int32) - onehot     # exclusive
    rank = pos.gather(0, flat_e[None, :])[0]
    return Routing(probs, gate, eidx, rank, _capacity(T, cfg))


def _aux_loss(r: Routing, E: int) -> torch.Tensor:
    """Switch-style load balancing: E * sum_e(token share_e * mean prob_e)."""
    me = r.probs.mean(dim=0)
    ce = (r.eidx[..., None] == torch.arange(E, device=r.eidx.device)
          ).float().sum(dim=1).mean(dim=0)
    return E * torch.sum(me * ce)


def moe_layer(p, x: torch.Tensor, cfg: ModelConfig,
              return_aux: bool = False):
    """x: (B, S, D) -> y (B, S, D) in the compute dtype, or (y, aux_loss)
    with ``return_aux``."""
    B, S, D = x.shape
    E = cfg.num_experts + cfg.moe_expert_pad   # padded experts are inert
    K = cfg.num_experts_per_tok
    cdt = dtype_of(cfg.compute_dtype)
    xt = x.reshape(B * S, D)
    T = B * S
    r = route(p, xt, cfg)
    C = r.capacity

    # ---- the (E+1, C) slot table: row E takes every dropped assignment
    flat_e = r.eidx.reshape(-1)
    keep = r.rank < C
    slot = torch.where(keep, flat_e * C + r.rank, E * C)       # (T*K,)
    flat_t = torch.arange(T, device=x.device)[:, None].expand(T, K) \
        .reshape(-1)
    slot_tok = torch.full(((E + 1) * C,), T, dtype=torch.long,
                          device=x.device)
    slot_tok.scatter_(0, slot, torch.where(keep, flat_t, T))
    slot_tok = slot_tok[:E * C]                  # T: the zero sentinel row

    # ---- gather -> expert FFN (batched over experts)
    xpad = torch.cat([xt, xt.new_zeros((1, D))])
    xe = xpad.index_select(0, slot_tok).view(E, C, D).to(cdt)
    h = F.silu(torch.bmm(xe, p["e_wg"].to(cdt))) \
        * torch.bmm(xe, p["e_wi"].to(cdt))
    eo = torch.bmm(h, p["e_wd"].to(cdt)).view(E * C, D)

    # ---- combine: a token's contributions in ascending expert id (a
    # dropped one reads the zero row E*C), gate-weighted in the compute
    # dtype as the reference's update rows
    eo = torch.cat([eo, eo.new_zeros((1, D))])
    order = r.eidx.argsort(dim=1)
    slot_tk = slot.view(T, K).gather(1, order)
    g_tk = r.gate.gather(1, order).to(cdt)
    contrib = eo.index_select(0, slot_tk.reshape(-1)).view(T, K, D) \
        * g_tk[..., None]
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    y = y.view(B, S, D)

    if cfg.shared_expert_d_ff:
        shared = mlp(p, x.to(cdt), cfg, prefix="shared_")
        sg = torch.sigmoid(x.float() @ p["shared_gate"].float())
        y = y + shared * sg.to(cdt)
    if cfg.dense_residual:
        y = y + mlp(p, x.to(cdt), cfg, prefix="dense_")
    if return_aux:
        return y, _aux_loss(r, E)
    return y

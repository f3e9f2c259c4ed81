"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

Counterpart of ``repro.models.moe``, on torch tensors. Each (token, expert)
assignment is ranked by the exclusive cumulative count of its expert over
the flattened (T*K) order (the reference's Switch-style ranking, no sort),
assignments ranked at or past the capacity C are dropped, and the kept ones
fill an (E+1, C) slot table whose last row is the sentinel of the dropped.
Then gather -> three batched expert products -> gate-weighted combine.
qwen2-moe adds its sigmoid-gated shared experts, arctic its dense FFN in
parallel with the MoE.

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

Under the sharded train step (a :class:`repro_torch.distributed.sharding.
TrainRegion` with ``dp`` above 1) each rank routes its rows, and the layer
is the reference's over the global batch, which XLA runs whole: the
capacity C is the global batch's, an assignment's rank among its
expert's counts the lower ``dp`` ranks' assignments before it (one
all-gather of the per-expert counts), and the aux loss is formed from the
global per-expert probability sums (summed over ``dp`` in the autograd
graph) and counts.

With its products partitioned over ``tp`` as well (``tp_part("moe")``, the
reference's rule table and its ``constrain`` of the dispatched rows to
``tp``), every ``tp`` rank holds the same rows, so the routing, the
capacity, the ranks and the aux loss come out the same on each, with no
exchange of rows. A rank runs the experts whose blocks it holds: its
``E / tp`` experts' slots of the table (rows ``[r E/tp C, (r+1) E/tp C)``;
a token whose slot is another rank's reads the zero row), or, where
``tp`` does not divide E, every slot on its ``1 / tp`` of the hidden
width. The experts' partial, the shared experts' partial times the
sigmoid gate and arctic's dense residual's are added before one sum over
``tp`` (one forward all-reduce, as a dense MLP's). The router and the
shared gate are formed in the replicated region; ``x``, the top-k gate
and the shared gate enter the partitioned one through ``copy_in``, whose
backward sums the ranks' partial gradients. The aux loss's router
gradient is thus counted once, and the gate's has every rank's experts.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.sharding import current_region, tp_part
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


def _over_dp(r: Routing, E: int, region, cfg: ModelConfig):
    """This rank's routing as part of the global batch's: the capacity of
    every ``dp`` rank's tokens together, and each assignment ranked after
    the lower ranks' assignments to its expert (their rows come first in
    the global order). Returns it and the global per-expert counts."""
    flat_e = r.eidx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int64, device=flat_e.device) \
        .index_add_(0, flat_e, torch.ones_like(flat_e))
    every = region.group.all_gather(counts[None], region.dp, 0)  # (dp, E)
    d = region.group.mesh.axis_index(region.dp, region.group.rank)
    before = every[:d].sum(dim=0)
    return r._replace(rank=r.rank + before[flat_e].to(r.rank.dtype),
                      capacity=_capacity(r.probs.shape[0]
                                         * region.dp_size, cfg)), \
        every.sum(dim=0)


def _aux_loss(r: Routing, E: int, region=None,
              counts=None) -> torch.Tensor:
    """Switch-style load balancing: E * sum_e(token share_e * mean prob_e);
    with ``region`` and the global per-expert ``counts``
    (:func:`_over_dp`), the global batch's: the probabilities' per-expert
    sums are summed over ``dp``."""
    if region is None:
        me = r.probs.mean(dim=0)
        ce = (r.eidx[..., None] == torch.arange(E, device=r.eidx.device)
              ).float().sum(dim=1).mean(dim=0)
    else:
        T = r.probs.shape[0] * region.dp_size
        me = region.sum_over_dp(r.probs.sum(dim=0)) / T
        ce = counts.float() / T
    return E * torch.sum(me * ce)


def moe_layer(p, x: torch.Tensor, cfg: ModelConfig,
              return_aux: bool = False):
    """x: (B, S, D) -> y (B, S, D) in the compute dtype, or (y, aux_loss)
    with ``return_aux``. Under the partitioned step (``tp_part("moe")``)
    ``p`` holds this rank's blocks of the experts and of the shared and
    dense MLPs, and y is their partials summed over ``tp`` once."""
    B, S, D = x.shape
    E = cfg.num_experts + cfg.moe_expert_pad   # padded experts are inert
    K = cfg.num_experts_per_tok
    cdt = dtype_of(cfg.compute_dtype)
    xt = x.reshape(B * S, D)
    T = B * S
    r = route(p, xt, cfg)
    region, counts = current_region(), None
    if region is None or region.dp_size == 1:
        region = None
    else:
        r, counts = _over_dp(r, E, region, cfg)
    C = r.capacity
    # formed before the partitioned products, so that a remat recompute
    # stops short of the layer's sum over tp
    aux = _aux_loss(r, E, region, counts) if return_aux else None
    part, xin, gate = tp_part("moe"), x, r.gate
    sg = torch.sigmoid(xt.float() @ p["shared_gate"].float()) \
        if cfg.shared_expert_d_ff else None
    if part is not None:
        # routing, the shared gate and the aux loss stay replicated (each
        # rank forms their whole gradient); the values the partitioned
        # products read enter the region, so their gradients are summed
        # (the two gates' in one reduction)
        xin = part.copy_in(x)
        xt = xin.reshape(T, D)
        if sg is None:
            gate = part.copy_in(gate)
        else:
            gate, sg = part.copy_in(torch.cat([gate, sg], dim=1)) \
                .split([K, 1], dim=1)

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

    # ---- this rank's experts: all E (whole, or a slice of the hidden
    # width each), or the El = E / tp from expert lo on, whose slots are
    # rows [lo C, (lo + El) C) of the table; any other slot reads the
    # zero row
    El = p["e_wi"].shape[0]
    if El < E:
        lo = part.tp_index * El
        slot_tok = slot_tok[lo * C:(lo + El) * C]
        slot = slot - lo * C
        slot = torch.where((slot >= 0) & (slot < El * C), slot, El * C)

    # ---- gather -> expert FFN (batched over experts)
    xpad = torch.cat([xt, xt.new_zeros((1, D))])
    xe = xpad.index_select(0, slot_tok).view(El, C, D).to(cdt)
    h = F.silu(torch.bmm(xe, p["e_wg"].to(cdt))) \
        * torch.bmm(xe, p["e_wi"].to(cdt))
    eo = torch.bmm(h, p["e_wd"].to(cdt)).view(El * C, D)

    # ---- combine: a token's contributions in ascending expert id (a
    # dropped one reads the zero row El*C), gate-weighted in the compute
    # dtype as the reference's update rows
    eo = torch.cat([eo, eo.new_zeros((1, D))])
    order = r.eidx.argsort(dim=1)
    slot_tk = slot.view(T, K).gather(1, order)
    g_tk = gate.gather(1, order).to(cdt)
    contrib = eo.index_select(0, slot_tk.reshape(-1)).view(T, K, D) \
        * g_tk[..., None]
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    y = y.view(B, S, D)

    # the shared experts' and the dense residual's partials join the
    # experts' before the one sum over tp
    inside = part is not None
    if cfg.shared_expert_d_ff:
        shared = mlp(p, xin.to(cdt), cfg, prefix="shared_", partial=inside,
                     kind="moe")
        y = y + shared * sg.view(B, S, 1).to(cdt)
    if cfg.dense_residual:
        y = y + mlp(p, xin.to(cdt), cfg, prefix="dense_", partial=inside,
                    kind="moe")
    if inside:
        y = part.reduce_out(y)
    return (y, aux) if return_aux else y

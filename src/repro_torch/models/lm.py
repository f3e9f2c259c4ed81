"""Decoder LM entry points for every registered family: dense attention,
MoE, Mamba1, the zamba2 hybrid and the modality-frontend archs (torch port
of ``repro.models.lm``).

Params are the plain dict of :mod:`repro_torch.params`: stacked per-layer
leaves under ``blocks`` (the hybrid: ``gblocks`` (G, every, ...),
``tail_blocks`` and one ``shared_block``). Each ``lax.scan`` over layers of
the reference is a Python loop here, and the paged pool ``(L, 2, N, KV, bs,
hd)`` is indexed ``pool[l]`` — a contiguous view that the attention code
writes IN PLACE (the reference returns a new pool; these functions return
the same tensor so call sites read alike). The slot-state pool of
:func:`init_cache` is written in place the same way by the slot entry
points.

zamba2 (``hybrid_attn_every``): G groups of ``every`` Mamba2 layers, each
followed by ONE shared transformer block (weights reused by every group)
fed ``concat([x, x0]) @ fused_proj``, x0 being the embeddings; then the
``L % every`` tail layers. Each group's shared-block call keeps its own KV
span: ``shared_k/v`` (G, B, KV, S_max, hd). Its prefill attention is K2 on
CUDA, like the dense prefill's; its slot decode reads the span in plain
torch (:func:`repro_torch.models.attention.decode_attention_rows`).

MoE archs (qwen2-moe, arctic) are attention archs whose FFN is
:func:`repro_torch.models.moe.moe_layer`: they page their KV and take the
dense entry points; its load-balancing loss is never computed here (the
reference's serving call sites discard it).

Modality frontends (musicgen-large's audio frames, internvl2-1b's image
patches) are stubs, as in the reference: ``frontend_embeds`` (B, F, D)
arrive precomputed and are put before the token embeddings, and every
position counts the F frames (:func:`_embed`).

Entry points: :func:`init_params`, :func:`prefill` (dense, Mamba1 and
hybrid branches, with ``frontend_embeds`` or ``last_positions``, never
both), :func:`init_cache` (every branch), the contiguous
:func:`decode_step` (every family), the paged path
:func:`prefill_window_paged`, :func:`decode_step_paged`,
:func:`decode_chunk_paged` (attention archs without a frontend, MoE
included, as in the reference), and the slot path
:func:`decode_step_slots`, :func:`decode_chunk_slots` (Mamba1 and the
hybrid).

Training (:func:`forward`, :func:`loss_fn`): teacher-forced fp32 logits
over the padded vocabulary and the reference's cross-entropy + z-loss +
router aux (offset by the F frames with a frontend), for every family,
differentiated by ``torch.autograd`` (Mamba1's scan through
:func:`repro_torch.kernels.ops.mamba_scan`: K3 and its backward
kernel on CUDA). With ``cfg.remat`` each layer is recomputed in the
backward (``torch.utils.checkpoint``, where the reference puts
``jax.checkpoint(..., nothing_saveable)``): per layer of a layer stack,
and per whole group (its Mamba2 layers and the shared block) in the
hybrid. The master weights may be fp32 (``param_dtype``): every layer
casts at use, so the gradients land in the fp32 leaves.

Under the sharded train step with its products partitioned over ``tp``
(:func:`repro_torch.distributed.sharding.tp_compute`) the embedding and
the head are vocab-parallel: each rank holds ``padded_vocab / tp`` rows of
``embed`` (columns of ``lm_head``), looks up the tokens of its range and
zeroes the rest before the sum over ``tp`` (:func:`_lookup`), and forms
only its logits' columns; :func:`loss_fn` then takes ``logz`` from the
global max and the global sum of exponentials and the gold logit from the
rank that holds the label (:func:`_vocab_parallel_ce`), so the ``(B, S,
V)`` logits are never gathered. A MoE layer runs its rank's experts
and sums its FFN's partials over ``tp`` once (:mod:`repro_torch.models.
moe`); a zamba2 Mamba2 layer its rank's SSD heads, and its shared block
gathers ``fused_proj``'s column blocks before the dense block's
partitioned attention and MLP (:func:`_shared_block`). A layer kind whose
widths ``tp`` does not divide runs whole on every rank
(:func:`repro_torch.distributed.sharding.tp_whole`). A remat recompute
re-enters the region (``checkpoint``'s ``context_fn``): on CUDA the
backward runs on another thread. The sharded prefill and decode steps
run :func:`prefill` and :func:`decode_step` in the same region: their
embedding is vocab-parallel too (the step gathers the logits), and their
KV caches are this rank's block of the sequence-parallel cache
(:func:`_kv_span`, :func:`repro_torch.models.attention.
decode_attention_rows`).

One device sync per decode chunk: :func:`decode_chunk_paged` and
:func:`decode_chunk_slots` keep the ``(lengths, last, rem)`` carry on the
device through their ``n`` steps (no ``.item()``/``.cpu()`` inside), so the
engine's read of the chunk's tokens is its only sync, as in the reference.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.sharding import current_region, tp_part, use_region
from .attention import (attention, decode_attention,
                        decode_attention_rows, paged_decode_attention,
                        paged_prefill_window_attention, seq_shard_kv)
from .layers import (column_parallel, dtype_of, matmul_f32, rms_norm,
                     sinusoidal_positions, tp_copy)
from .mamba import init_mamba_state, mamba_forward, mamba_step
from .mlp import mlp
from .moe import moe_layer

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "prefill",
           "decode_step", "prefill_window_paged",
           "decode_step_paged", "decode_chunk_paged", "decode_step_slots",
           "decode_chunk_slots", "layer_views"]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """See :func:`repro_torch.params.init_params`."""
    from ..params import init_params as _init
    return _init(cfg, generator, device=device)


def _frontend_len(cfg: ModelConfig) -> int:
    """F, the frontend frames before the tokens (0 without a frontend)."""
    return cfg.frontend_tokens if cfg.frontend != "none" else 0


def _require_dense(cfg: ModelConfig, what: str) -> None:
    """The paged entry points: attention archs without a frontend, as in
    the reference (SSM state is O(1) per sequence and lives in the slot
    pool; the reference engine never feeds frontend frames)."""
    if cfg.ssm or _frontend_len(cfg):
        raise ValueError(f"{cfg.name}: {what} in repro_torch covers "
                         "attention archs (dense and MoE) without a "
                         f"frontend (family {cfg.family!r}, frontend "
                         f"{cfg.frontend!r})")


def _require_slots(cfg: ModelConfig, what: str) -> None:
    """The slot-state entry points: SSM and hybrid archs (attention archs
    page their KV instead)."""
    if not cfg.ssm:
        raise ValueError(f"{cfg.name}: {what} is the SSM path; attention "
                         "archs page their KV instead")


def layer_views(params) -> List[Dict[str, torch.Tensor]]:
    """Layer ``l``'s weights as views into the stacked leaves (no copy),
    for every ``l`` in execution order (the hybrid: group 0's layers, group
    1's, ..., then the tail's; its shared block is read from
    ``params["shared_block"]``). Making ~a dozen views per layer per decode
    step costs more host time than a small model's layer math, so a caller
    on the hot path (the engine) builds this list once and passes it as
    ``layers=`` to the entry points; without it each call builds its
    own."""
    if "gblocks" not in params:
        return _stack_views(params["blocks"])
    views = [lp for group in _stack_views(params["gblocks"])
             for lp in _stack_views(group)]
    if "tail_blocks" in params:
        views += _stack_views(params["tail_blocks"])
    return views


def _stack_views(stack) -> List[Dict[str, torch.Tensor]]:
    # unbind, not v[l]: under autograd each leaf then gets ONE backward
    # node that stacks the L layer gradients, where L separate selects
    # would each scatter into a zero tensor of the whole stack
    names = tuple(stack)
    return [dict(zip(names, views))
            for views in zip(*(stack[k].unbind(0) for k in names))]


def _embed(cfg: ModelConfig, params, tokens: torch.Tensor,
           frontend_embeds: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole sequence's input (the reference's ``_embed``): with a
    frontend, ``frontend_embeds`` (B, F, D) cast to the compute dtype and
    put before the token embeddings; positions ``arange(F + S)`` per row
    (sinusoidal ones added over all of them). Returns (x (B, F + S, D),
    positions). A frontend arch without ``frontend_embeds`` raises, as in
    the reference; other archs ignore them."""
    if cfg.frontend != "none" and frontend_embeds is None:
        raise ValueError(f"{cfg.name} requires frontend_embeds "
                         f"({cfg.frontend} stub)")
    cdt = dtype_of(cfg.compute_dtype)
    x = _lookup(params["embed"], tokens).to(cdt)
    if cfg.frontend != "none":
        x = torch.cat([frontend_embeds.to(cdt), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(cdt)
    return x, positions


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; vocab-parallel under the partitioned step (this
    rank's rows of ``embed``: the tokens of its range looked up, the rest
    zero, then the sum over ``tp``)."""
    part = tp_part("vocab")
    if part is None:
        return F.embedding(tokens.long(), embed)
    n = embed.shape[0]
    t = tokens.long() - part.tp_index * n
    inside = (t >= 0) & (t < n)
    x = F.embedding(torch.where(inside, t, 0), embed)
    return part.reduce_out(torch.where(inside[..., None], x, 0.0))


def _embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    x = _lookup(params["embed"], tokens).to(cdt)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(cdt)
    return x


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: (B, D) -> (B, padded_vocab) fp32. Padded vocab
    columns stay unmasked, as in the reference. Under the partitioned step
    the head is this rank's vocab columns, and so are the logits."""
    cdt = dtype_of(cfg.compute_dtype)
    x = tp_copy(rms_norm(x, params["final_norm"], cfg.rms_eps), "vocab")
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return matmul_f32(x, head.to(cdt))


# ------------------------------------------------------------------ blocks
def _ffn(p, h2, cfg: ModelConfig) -> torch.Tensor:
    """The layer's FFN on (B, S, D): the MoE layer (its aux loss not
    computed) or the MLP."""
    return moe_layer(p, h2, cfg) if cfg.moe else mlp(p, h2, cfg)


def _block_decode(p, x1, cfg: ModelConfig, layer_cache, attn_fn):
    """One layer, one token. x1: (B, D). ``attn_fn(p, h1, layer_cache) ->
    (y, layer_cache)`` is the paged attention read/write; ln1, residuals,
    ln2 and the FFN (MLP or MoE) are shared with the window path. A Mamba1
    layer steps its ``(conv_buf, h)`` state instead (``attn_fn`` unused)."""
    h = rms_norm(x1, p["ln1"], cfg.rms_eps)
    if cfg.ssm:
        y, st = mamba_step(p, h, cfg, layer_cache)
        return x1 + y, st
    y, layer_cache = attn_fn(p, h[:, None, :], layer_cache)
    x1 = x1 + y[:, 0]
    h2 = rms_norm(x1, p["ln2"], cfg.rms_eps)
    x1 = x1 + _ffn(p, h2[:, None, :], cfg)[:, 0]
    return x1, layer_cache


def _block_window(p, x, cfg: ModelConfig, attn_fn, pkv_l):
    """One layer over a chunked-prefill window (mirrors the prefill block
    with the attention swapped for a paged read/write)."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    y, pkv_l = attn_fn(p, h, pkv_l)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.rms_eps)
    x = x + _ffn(p, h2, cfg)
    return x, pkv_l


# ------------------------------------------------------------------ training
def _block_train(p, x, cfg: ModelConfig, positions):
    """One layer over the whole sequence (the reference's ``_block_apply``:
    chunked attention and the MLP or MoE, or a Mamba block). Returns (x,
    MoE aux)."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    if cfg.ssm:
        return x + mamba_forward(p, h, cfg), torch.zeros((), device=x.device)
    x = x + attention(p, h, cfg, positions)
    h2 = rms_norm(x, p["ln2"], cfg.rms_eps)
    if cfg.moe:
        y, aux = moe_layer(p, h2, cfg, return_aux=True)
        return x + y, aux
    return x + mlp(p, h2, cfg), torch.zeros((), device=x.device)


def _group_train(layers, sb, x, x0, cfg: ModelConfig, positions):
    """One zamba2 group over the whole sequence: its Mamba2 layers, then
    the shared block fed (x, x0) (the reference's ``group``)."""
    for lp in layers:
        x, _ = _block_train(lp, x, cfg, positions)
    return _shared_block(sb, x, x0, cfg, positions)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits over the whole (frontend + token) sequence:
    ``(logits (B, F + S, padded_vocab) fp32, MoE aux loss)``. The hybrid
    runs its G groups (``every`` Mamba2 layers, then the shared block on
    (x, the embeddings)), then its tail layers. The recomputation keeps no
    RNG state: no layer draws random numbers."""
    x, positions = _embed(cfg, params, tokens, frontend_embeds)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    recompute = functools.partial(_checkpoint, current_region())
    layers = layer_views(params)
    if cfg.hybrid_attn_every:
        every = cfg.hybrid_attn_every
        G = params["gblocks"]["ln1"].shape[0]
        x0 = x
        for g in range(G):
            args = (layers[g * every:(g + 1) * every],
                    params["shared_block"], x, x0, cfg, positions)
            x = recompute(_group_train, *args) if remat \
                else _group_train(*args)
        layers = layers[G * every:]
    for lp in layers:
        if remat:
            x, a = recompute(_block_train, lp, x, cfg, positions)
        else:
            x, a = _block_train(lp, x, cfg, positions)
        aux = aux + a
    return _logits(cfg, params, x), aux


def _checkpoint(region, fn, *args):
    """``fn(*args)`` recomputed in the backward (no RNG state kept); the
    recompute runs inside ``region``, the sharded step's, as the forward
    did, whichever thread the backward runs on."""
    def contexts():
        return contextlib.nullcontext(), use_region(region)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts)


def _vocab_parallel_ce(cfg: ModelConfig, pred: torch.Tensor,
                       labels: torch.Tensor, part):
    """(logz, gold) of vocab-parallel logits: ``pred`` holds this rank's
    ``padded_vocab / tp`` columns, the padded ones (by their global index)
    masked to -1e30; the max, the sum of exponentials and the gold logit
    are summed over ``tp``."""
    n = pred.shape[-1]
    lo = part.tp_index * n
    cols = lo + torch.arange(n, device=pred.device)
    pred = pred.masked_fill(cols >= cfg.vocab_size, -1e30)
    m = part.max_over_tp(pred.amax(dim=-1))
    sumexp = part.reduce_out(torch.exp(pred - m[..., None]).sum(dim=-1))
    logz = m + torch.log(sumexp)
    t = labels - lo
    inside = (t >= 0) & (t < n)
    gold = pred.gather(-1, torch.where(inside, t, 0)[..., None])[..., 0]
    return logz, part.reduce_out(torch.where(inside, gold, 0.0))


def loss_fn(cfg: ModelConfig, params, batch) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy in fp32 over the real vocabulary (the
    padded columns masked to -1e30), + ``1e-4 * mean(logz^2)`` +
    ``router_aux_weight * aux``. With a frontend of F frames
    (``batch["frontend_embeds"]``) the logits at F - 1 .. F + S - 2
    predict the S tokens, as in the reference. The gold logit is a gather:
    the reference's one-hot sum has one nonzero term, so it is the same
    number, without a (B, S, V) one-hot. Under the partitioned step the
    logits are this rank's vocab columns (:func:`_vocab_parallel_ce`).
    Returns (total, {"ce", "aux", "zloss", "ppl_proxy"})."""
    tokens = batch["tokens"]
    logits, aux = forward(cfg, params, tokens, batch.get("frontend_embeds"))
    S = tokens.shape[1]
    nf = _frontend_len(cfg)
    if nf:
        pred = logits[:, nf - 1:nf + S - 1]
        labels = tokens.long()
    else:
        pred = logits[:, :S - 1]
        labels = tokens[:, 1:].long()
    part = tp_part("vocab")
    if part is not None:
        logz, gold = _vocab_parallel_ce(cfg, pred, labels, part)
    else:
        padded = torch.arange(cfg.padded_vocab, device=pred.device) \
            >= cfg.vocab_size
        pred = pred.masked_fill(padded, -1e30)
        logz = torch.logsumexp(pred, dim=-1)
        gold = pred.gather(-1, labels[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    zloss = 1e-4 * torch.mean(torch.square(logz))
    total = ce + zloss + cfg.router_aux_weight * aux
    return total, {"ce": ce, "aux": aux, "zloss": zloss,
                   "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}


# ------------------------------------------------------------------ serving
def decode_step_paged(cfg: ModelConfig, params, pool_kv, tables, lengths,
                      token, active, impl: Optional[str] = None,
                      layers=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step through the paged KV cache (continuous batching).

    pool_kv: (L, 2, N, KV, block, hd), written in place; tables:
    (B, max_blocks) int32; lengths: (B,) int32 (where row ``b``'s next KV
    entry lands and how far its mask extends); token: (B,) int; active:
    (B,) bool. ``impl`` picks the attention read path (see
    :func:`repro_torch.models.attention.paged_decode_attention`);
    ``layers`` is :func:`layer_views` of ``params``, built here when None.
    Returns (logits (B, padded_vocab) fp32, pool_kv).
    """
    _require_dense(cfg, "paged decode")
    pos = lengths
    x1 = _embed_tokens(cfg, params, token, pos)

    def paged_attn(lp, h1, pkv_l):
        return paged_decode_attention(lp, h1, cfg, pkv_l, tables, pos,
                                      active, impl=impl)

    for l, lp in enumerate(layers or layer_views(params)):
        x1, _ = _block_decode(lp, x1, cfg, pool_kv[l], paged_attn)
    return _logits(cfg, params, x1), pool_kv


def _decode_chunk_scan(step, state, carry, n: int):
    """``n`` greedy steps of ``step(state, tok, lengths, active) ->
    (logits, state)`` threading the device carry. Rows with ``rem == 0``
    are inactive: their token repeats and the engine discards their emitted
    tokens host-side. No host sync inside."""
    ln, tok, rm = carry[0], carry[1], carry[2]
    toks = []
    for _ in range(n):
        active = rm > 0
        logits, state = step(state, tok, ln, active)
        # greedy ties: torch.argmax returns the first maximum, as jnp.argmax
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(active, nxt, tok)
        ln = ln + active.to(ln.dtype)
        rm = rm - active.to(rm.dtype)
        tok = nxt
        toks.append(nxt)
    return state, (ln, tok, rm), torch.stack(toks, dim=1)


def decode_chunk_paged(cfg: ModelConfig, params, pool_kv, tables, carry,
                       n: int, impl: Optional[str] = None, layers=None):
    """``n`` greedy paged decode steps over the resident batch — the chunk
    program of the continuous-batching engine. ``carry = (lengths, last,
    rem)`` are (B,) int32 device tensors. Returns ``(pool_kv, (lengths,
    last, rem), toks)`` with ``toks`` (B, n) int32 (rows active for
    ``k < n`` steps repeat their final token in the tail)."""
    _require_dense(cfg, "paged decode")
    layers = layers or layer_views(params)

    def step(pkv, tok, ln, active):
        return decode_step_paged(cfg, params, pkv, tables, ln, tok, active,
                                 impl=impl, layers=layers)

    return _decode_chunk_scan(step, pool_kv, carry, n)


def prefill_window_paged(cfg: ModelConfig, params, pool_kv, tables, tokens,
                         start, valid, last_idx, layers=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Process one chunked-prefill WINDOW for every mid-prefill row of the
    resident batch, writing the window's KV straight into the paged pool
    (in place).

    tokens: (B, C) int window tokens; start: (B,) int per-row window
    origin; valid: (B, C) bool; last_idx: (B,) int window column of each
    row's final prompt token (clipped into range); ``layers`` as in
    :func:`decode_step_paged`. Returns (first_tokens (B,) int32 greedy,
    pool_kv).
    """
    _require_dense(cfg, "paged chunked prefill")
    B, C = tokens.shape
    positions = start.long()[:, None] \
        + torch.arange(C, device=tokens.device)[None, :]
    x = _embed_tokens(cfg, params, tokens, positions)

    def win_attn(lp, h, pkv_l):
        return paged_prefill_window_attention(lp, h, cfg, pkv_l, tables,
                                              positions, valid)

    for l, lp in enumerate(layers or layer_views(params)):
        x, _ = _block_window(lp, x, cfg, win_attn, pool_kv[l])
    x_last = x[torch.arange(B, device=x.device), last_idx.long()]
    logits = _logits(cfg, params, x_last)
    return torch.argmax(logits, dim=-1).to(torch.int32), pool_kv


def prefill(cfg: ModelConfig, params, tokens, max_len: int = 0,
            last_positions=None, impl: Optional[str] = None, layers=None,
            frontend_embeds=None):
    """Process a prompt: last-position logits (B, padded_vocab) fp32 and a
    primed cache over the F frontend frames (``frontend_embeds`` (B, F, D),
    frontend archs only) and the S tokens: its ``pos`` is F + S and
    ``max_len`` is raised to at least F + S.

    Dense archs: ``{"pos", "k", "v"}`` with k/v (L, B, KV, max_len, hd) in
    the compute dtype; ``impl`` is the attention path, ``"flash"`` (K2) by
    default on CUDA and ``"chunked"`` (the reference's default, also the
    plain oracle) on the CPU.

    Mamba1 archs: ``{"pos", "ssm": (conv (L, B, K-1, dI) in the compute
    dtype, h (L, B, dI, N) fp32)}``, the per-layer state a decode continues
    from (``max_len`` is unused); ``impl`` is the scan, ``"kernel"`` by
    default (K3 on CUDA, the plain scan for CPU tensors) or ``"plain"``.

    The zamba2 hybrid: :func:`init_cache`'s hybrid leaves, ``g_ssm`` (conv
    (G, every, B, K-1, dI+2N), h (G, every, B, nh, hp, N)), ``tail_ssm``
    and ``shared_k/v`` (G, B, KV, max(max_len, S), hd); ``impl`` is the
    shared block's attention, as for dense archs (K2 on CUDA by default).

    ``last_positions`` ((B,) int, optional) picks a per-row logit position;
    with a frontend it raises, as in the reference (it would index the
    concatenated sequence). ``layers`` as in :func:`decode_step_paged`.
    """
    if _frontend_len(cfg) and last_positions is not None:
        raise ValueError(f"{cfg.name}: last_positions does not account for "
                         "the frontend prefix; offset by frontend_tokens "
                         "first")
    x, positions = _embed(cfg, params, tokens, frontend_embeds)
    B, S = x.shape[:2]
    layers = layers or layer_views(params)
    attn_impl = impl or ("flash" if tokens.is_cuda else "chunked")
    if cfg.hybrid_attn_every:
        x, cache = _prefill_hybrid(cfg, params, layers, x, positions,
                                   max(max_len, S), attn_impl)
    elif cfg.ssm:
        x, cache = _prefill_ssm(cfg, layers, x, impl or "kernel")
    else:
        x, cache = _prefill_attention(cfg, layers, x, positions,
                                      max(max_len, S), attn_impl)
    x_last = x[:, -1] if last_positions is None \
        else x[torch.arange(B, device=x.device), last_positions.long()]
    logits = _logits(cfg, params, x_last)
    cache["pos"] = S
    return logits, cache


def _kv_span(cfg: ModelConfig, k, v, max_len: int):
    """A prefill's (B, S, KV, hd) K and V as (B, KV, max_len, hd) cache
    spans in the compute dtype, zero past S; in a sharded serve step this
    rank's block of the sequence-parallel cache, (B, KV, max_len / sp, hd)
    of every KV head (:func:`repro_torch.models.attention.seq_shard_kv`)."""
    cdt = dtype_of(cfg.compute_dtype)
    pad = max_len - k.shape[1]
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    region = current_region()
    if region is not None and (region.sp_size > 1
                               or tp_part("attn") is not None):
        k, v = seq_shard_kv(k, v, cfg, region)
    return k.transpose(1, 2).to(cdt), v.transpose(1, 2).to(cdt)


def _prefill_attention(cfg: ModelConfig, layers, x, positions, max_len: int,
                       impl: str):
    ks, vs = [], []
    for lp in layers:
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        y, (k, v) = attention(lp, h, cfg, positions, impl=impl,
                              return_kv=True)
        x = x + y
        h2 = rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + _ffn(lp, h2, cfg)
        k, v = _kv_span(cfg, k, v, max_len)
        ks.append(k)
        vs.append(v)
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


def _prefill_ssm(cfg: ModelConfig, layers, x, impl: str):
    cdt = dtype_of(cfg.compute_dtype)
    convs, hs = [], []
    for lp in layers:
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        y, (conv, hh) = mamba_forward(lp, h, cfg, return_state=True,
                                      impl=impl)
        x = x + y
        convs.append(conv.to(cdt))
        hs.append(hh)
    return x, {"ssm": (torch.stack(convs), torch.stack(hs))}


def _shared_block(sb, x, x0, cfg: ModelConfig, positions,
                  impl: str = "chunked", return_kv: bool = False):
    """zamba2's shared block over the whole sequence (the reference's
    ``_shared_block_apply``): concat([x, x0]) @ fused_proj -> attention ->
    MLP, added to x. With ``return_kv`` returns (x, (k, v)), k/v (B, S, KV,
    hd) as :func:`repro_torch.models.attention.attention` gives them.
    Under the partitioned step ``fused_proj`` is column-parallel and its
    output's blocks are gathered over ``tp`` (the norm and the residual
    read all of it); attention and the MLP are the dense block's."""
    cdt = dtype_of(cfg.compute_dtype)
    (h,) = column_parallel(torch.cat([x, x0], dim=-1),
                           sb["fused_proj"].to(cdt), kind="fused")
    part = tp_part("fused")
    if part is not None:
        h = part.gather_over_tp(h)
    a = attention(sb, rms_norm(h, sb["ln1"], cfg.rms_eps), cfg, positions,
                  impl=impl, return_kv=return_kv)
    if return_kv:
        a, kv = a
    h = h + a
    h = h + mlp(sb, rms_norm(h, sb["ln2"], cfg.rms_eps), cfg)
    return (x + h, kv) if return_kv else x + h


def _prefill_hybrid(cfg: ModelConfig, params, layers, x, positions,
                    max_len: int, impl: str):
    """Each group's Mamba2 layers, then the shared block on (x, x0) with its
    own KV span, then the tail layers (the reference's hybrid prefill)."""
    cdt = dtype_of(cfg.compute_dtype)
    every = cfg.hybrid_attn_every
    G = cfg.num_layers // every
    x0 = x
    convs, hs, ks, vs = [], [], [], []
    for i, lp in enumerate(layers):
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        y, (conv, hh) = mamba_forward(lp, h, cfg, return_state=True)
        x = x + y
        convs.append(conv.to(cdt))
        hs.append(hh)
        if i < G * every and i % every == every - 1:
            x, (k, v) = _shared_block(params["shared_block"], x, x0, cfg,
                                      positions, impl, return_kv=True)
            k, v = _kv_span(cfg, k, v, max_len)
            ks.append(k)
            vs.append(v)
    n = G * every

    def groups(ts):
        return torch.stack(ts[:n]).unflatten(0, (G, every))

    cache = {"g_ssm": (groups(convs), groups(hs)),
             "shared_k": torch.stack(ks), "shared_v": torch.stack(vs)}
    if len(layers) > n:
        cache["tail_ssm"] = (torch.stack(convs[n:]), torch.stack(hs[n:]))
    return x, cache


# ------------------------------------------------------------ slot state
def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               device=None) -> Dict[str, Any]:
    """The decode cache (the reference's ``init_cache``), zeros; ``device``
    None means CUDA. The serve engine's fixed-slot pool is an SSM or hybrid
    arch's cache minus ``pos``.

    Attention archs (dense and MoE): ``{"pos": 0, "k", "v"}`` with k/v
    (L, batch, KV, max_len, hd) in the compute dtype. Mamba1: ``{"pos": 0, "ssm": (conv (L, batch, K-1, dI) in the compute
    dtype, h (L, batch, dI, N) fp32)}``; ``max_len`` is unused (an SSM's
    state does not grow). The zamba2 hybrid: ``g_ssm`` (conv (G, every,
    batch, K-1, dI+2N), h (G, every, batch, nh, hp, N) fp32), ``tail_ssm``
    ((tail, batch, ...) likewise, when ``L % every``) and ``shared_k``,
    ``shared_v`` (G, batch, KV, max_len, hd) in the compute dtype. A
    frontend arch's cache is its attention branch's (a prefill's covers
    the frames too)."""
    cdt = dtype_of(cfg.compute_dtype)
    dev = resolve_device(device)
    if not cfg.ssm:
        kv = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.hd)
        return {"pos": 0, "k": torch.zeros(kv, dtype=cdt, device=dev),
                "v": torch.zeros(kv, dtype=cdt, device=dev)}
    conv, h = init_mamba_state(cfg, batch, cdt, dev)

    def stack(t, lead):
        return t.expand(*lead, *t.shape).clone()

    L, every = cfg.num_layers, cfg.hybrid_attn_every
    if not every:
        return {"pos": 0, "ssm": (stack(conv, (L,)), stack(h, (L,)))}
    G, tail = divmod(L, every)
    kv = (G, batch, cfg.num_kv_heads, max_len, cfg.hd)
    cache = {"pos": 0,
             "g_ssm": (stack(conv, (G, every)), stack(h, (G, every))),
             "shared_k": torch.zeros(kv, dtype=cdt, device=dev),
             "shared_v": torch.zeros(kv, dtype=cdt, device=dev)}
    if tail:
        cache["tail_ssm"] = (stack(conv, (tail,)), stack(h, (tail,)))
    return cache


def decode_step(cfg: ModelConfig, params, cache, token, layers=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One greedy-path decode step from a contiguous cache (the reference's
    ``decode_step``): the cache of :func:`prefill` or :func:`init_cache`,
    every row at the cache's scalar ``pos`` (F + S after a prefill of F
    frontend frames and S tokens). Attention archs (dense, MoE and the
    frontend archs) read and write their (L, B, KV, S_max, hd) cache through
    :func:`repro_torch.models.attention.decode_attention`; Mamba1 and the
    hybrid step their state through the slot path's pieces
    (:func:`decode_step_slots` with every row at ``pos``). Tensors are
    updated IN PLACE; the returned dict is a new one with ``pos + 1``.
    token: (B,) int. Returns (logits (B, padded_vocab) fp32, cache)."""
    pos = int(cache["pos"])
    pos_b = torch.full((token.shape[0],), pos, dtype=torch.int32,
                       device=token.device)
    layers = layers or layer_views(params)
    if cfg.ssm:
        logits, _ = decode_step_slots(cfg, params, cache, token, pos_b,
                                      layers=layers)
    else:
        x1 = _embed_tokens(cfg, params, token, pos_b)

        def attn(lp, h1, kv):
            y, ck, cv = decode_attention(lp, h1, cfg, kv[0], kv[1], pos)
            return y, (ck, cv)

        for l, lp in enumerate(layers):
            x1, _ = _block_decode(lp, x1, cfg,
                                  (cache["k"][l], cache["v"][l]), attn)
        logits = _logits(cfg, params, x1)
    new = dict(cache)
    new["pos"] = pos + 1
    return logits, new


def _shared_block_decode_rows(p, x1, x0, cfg: ModelConfig, ck, cv, pos):
    """Per-row-position zamba2 shared block (slot-resident decode); ck/cv
    are this group's (B, KV, S_max, hd) spans, written in place. In a
    sharded serve step ``fused_proj`` is column-parallel and its output
    gathered over ``tp``, as in :func:`_shared_block`, and ck/cv are this
    rank's blocks of the sequence-parallel spans."""
    cdt = dtype_of(cfg.compute_dtype)
    (h,) = column_parallel(torch.cat([x1, x0], dim=-1),
                           p["fused_proj"].to(cdt), kind="fused")
    part = tp_part("fused")
    if part is not None:
        h = part.gather_over_tp(h)
    a, _, _ = decode_attention_rows(
        p, rms_norm(h, p["ln1"], cfg.rms_eps)[:, None, :], cfg, ck, cv, pos)
    h = h + a[:, 0]
    h = h + mlp(p, rms_norm(h, p["ln2"], cfg.rms_eps)[:, None, :],
                cfg)[:, 0]
    return x1 + h


def decode_step_slots(cfg: ModelConfig, params, state, token, pos,
                      layers=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step over the SLOT-RESIDENT state pool of an SSM or
    hybrid arch, with per-row positions (the counterpart of
    :func:`decode_step_paged`).

    ``state`` is :func:`init_cache`'s dict minus ``pos``; its tensors are
    updated IN PLACE (each layer's new ``(conv, h)`` is copied into them;
    the hybrid's shared block writes each row's K and V at ``pos[b]`` of
    its group's span, so every ``pos[b]`` must be below the span's length)
    and the same dict is returned. Every op is row-wise, so a
    row's tokens do not depend on who shares the batch; inactive slots step
    on stale state harmlessly (the engine discards their tokens and
    overwrites the slot at the next admission). token: (B,) int; pos: (B,)
    int per-row position. Returns (logits (B, padded_vocab) fp32, state).
    """
    _require_slots(cfg, "slot-state decode")
    x1 = _embed_tokens(cfg, params, token, pos)
    layers = layers or layer_views(params)
    if not cfg.hybrid_attn_every:
        x1 = _ssm_layers_step(cfg, layers, x1, state["ssm"])
        return _logits(cfg, params, x1), state
    every = cfg.hybrid_attn_every
    x0 = x1
    conv, h = state["g_ssm"]
    for g in range(conv.shape[0]):
        x1 = _ssm_layers_step(cfg, layers[g * every:(g + 1) * every], x1,
                              (conv[g], h[g]))
        x1 = _shared_block_decode_rows(params["shared_block"], x1, x0, cfg,
                                       state["shared_k"][g],
                                       state["shared_v"][g], pos)
    if "tail_ssm" in state:
        x1 = _ssm_layers_step(cfg, layers[conv.shape[0] * every:], x1,
                              state["tail_ssm"])
    return _logits(cfg, params, x1), state


def _ssm_layers_step(cfg: ModelConfig, layers, x1, ssm):
    """One token through a run of Mamba layers; ``ssm`` = (conv, h) stacked
    over those layers, each layer's new state copied in place."""
    conv, h = ssm
    for l, lp in enumerate(layers):
        x1, (conv_l, h_l) = _block_decode(lp, x1, cfg, (conv[l], h[l]),
                                          None)
        conv[l].copy_(conv_l)
        h[l].copy_(h_l)
    return x1


def decode_chunk_slots(cfg: ModelConfig, params, state, carry, n: int,
                       layers=None):
    """``n`` greedy decode steps over the slot-state pool — the SSM and
    hybrid counterpart of :func:`decode_chunk_paged`, with the same
    device-resident ``(lengths, last, rem)`` carry. Returns ``(state, (lengths, last, rem),
    toks)`` with ``toks`` (B, n) int32."""
    _require_slots(cfg, "slot-state decode")
    layers = layers or layer_views(params)

    def step(st, tok, ln, active):
        return decode_step_slots(cfg, params, st, tok, ln, layers=layers)

    return _decode_chunk_scan(step, state, carry, n)

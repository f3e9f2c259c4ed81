"""Decoder LM serving entry points, dense attention and Mamba1 archs (torch
port of ``repro.models.lm``).

Params are the plain dict of :mod:`repro_torch.params`: stacked per-layer
leaves under ``blocks``. Each ``lax.scan`` over layers of the reference is a
Python loop here, and the paged pool ``(L, 2, N, KV, bs, hd)`` is indexed
``pool[l]`` — a contiguous view that the attention code writes IN PLACE
(the reference returns a new pool; these functions return the same tensor
so call sites read alike). The SSM slot-state pool of :func:`init_cache`
is written in place the same way by the slot entry points.

Entry points: :func:`init_params`, :func:`prefill` (dense and Mamba1
branches, with ``last_positions``), :func:`init_cache` (Mamba1 slot
state), the paged path :func:`prefill_window_paged`,
:func:`decode_step_paged`, :func:`decode_chunk_paged` (attention archs
only, as in the reference), and the slot path :func:`decode_step_slots`,
:func:`decode_chunk_slots` (Mamba1 only). MoE, Mamba2/hybrid and
modality-frontend configs raise ``ValueError`` (later slices).

One device sync per decode chunk: :func:`decode_chunk_paged` and
:func:`decode_chunk_slots` keep the ``(lengths, last, rem)`` carry on the
device through their ``n`` steps (no ``.item()``/``.cpu()`` inside), so the
engine's read of the chunk's tokens is its only sync, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (attention, paged_decode_attention,
                        paged_prefill_window_attention)
from .layers import dtype_of, matmul_f32, rms_norm, sinusoidal_positions
from .mamba import init_mamba_state, mamba_forward, mamba_step
from .mlp import mlp

__all__ = ["init_params", "init_cache", "prefill", "prefill_window_paged",
           "decode_step_paged", "decode_chunk_paged", "decode_step_slots",
           "decode_chunk_slots", "layer_views"]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """See :func:`repro_torch.params.init_params`."""
    from ..params import init_params as _init
    return _init(cfg, generator, device=device)


def _unported(cfg: ModelConfig) -> bool:
    """MoE, Mamba2/hybrid and modality-frontend archs: later slices."""
    return bool(cfg.moe or cfg.hybrid_attn_every or cfg.frontend != "none"
                or (cfg.ssm and cfg.ssm_version != 1))


def _require_dense(cfg: ModelConfig, what: str) -> None:
    """The paged entry points: attention archs only, as in the reference
    (SSM state is O(1) per sequence and lives in the slot pool)."""
    if cfg.ssm or _unported(cfg):
        raise ValueError(f"{cfg.name}: {what} in repro_torch covers dense "
                         f"attention archs only (family {cfg.family!r}, "
                         f"frontend {cfg.frontend!r})")


def _require_ported(cfg: ModelConfig, what: str) -> None:
    if _unported(cfg):
        raise ValueError(f"{cfg.name}: {what} in repro_torch covers dense "
                         "attention and Mamba1 archs only (family "
                         f"{cfg.family!r}, frontend {cfg.frontend!r} are not "
                         "ported yet)")


def _require_slots(cfg: ModelConfig, what: str) -> None:
    """The slot-state entry points: Mamba1 only (zamba2's hybrid slots come
    with its slice; attention archs page their KV instead)."""
    _require_ported(cfg, what)
    if not cfg.ssm:
        raise ValueError(f"{cfg.name}: {what} is the SSM path; attention "
                         "archs page their KV instead")


def layer_views(params) -> List[Dict[str, torch.Tensor]]:
    """Layer ``l``'s weights as views into the stacked leaves (no copy),
    for every ``l``. Making ~a dozen views per layer per decode step costs
    more host time than a small model's layer math, so a caller on the hot
    path (the engine) builds this list once and passes it as ``layers=``
    to the entry points; without it each call builds its own."""
    leaves = tuple(params["blocks"].items())
    return [{k: v[l] for k, v in leaves}
            for l in range(leaves[0][1].shape[0])]


def _embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    cdt = dtype_of(cfg.compute_dtype)
    x = params["embed"][tokens.long()].to(cdt)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(cdt)
    return x


def _logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: (B, D) -> (B, padded_vocab) fp32. Padded vocab
    columns stay unmasked, as in the reference."""
    cdt = dtype_of(cfg.compute_dtype)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return matmul_f32(x, head.to(cdt))


# ------------------------------------------------------------------ blocks
def _block_decode(p, x1, cfg: ModelConfig, layer_cache, attn_fn):
    """One layer, one token. x1: (B, D). ``attn_fn(p, h1, layer_cache) ->
    (y, layer_cache)`` is the paged attention read/write; ln1, residuals,
    ln2 and the MLP are shared with the window path. A Mamba1 layer steps
    its ``(conv_buf, h)`` state instead (``attn_fn`` unused)."""
    h = rms_norm(x1, p["ln1"], cfg.rms_eps)
    if cfg.ssm:
        y, st = mamba_step(p, h, cfg, layer_cache)
        return x1 + y, st
    y, layer_cache = attn_fn(p, h[:, None, :], layer_cache)
    x1 = x1 + y[:, 0]
    h2 = rms_norm(x1, p["ln2"], cfg.rms_eps)
    x1 = x1 + mlp(p, h2[:, None, :], cfg)[:, 0]
    return x1, layer_cache


def _block_window(p, x, cfg: ModelConfig, attn_fn, pkv_l):
    """One layer over a chunked-prefill window (mirrors the prefill block
    with the attention swapped for a paged read/write)."""
    h = rms_norm(x, p["ln1"], cfg.rms_eps)
    y, pkv_l = attn_fn(p, h, pkv_l)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.rms_eps)
    x = x + mlp(p, h2, cfg)
    return x, pkv_l


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
            last_positions=None, impl: Optional[str] = None, layers=None):
    """Process a prompt: last-position logits (B, padded_vocab) fp32 and a
    primed cache.

    Dense archs: ``{"pos", "k", "v"}`` with k/v (L, B, KV, max_len, hd) in
    the compute dtype; ``impl`` is the attention path, ``"flash"`` (K2) by
    default on CUDA and ``"chunked"`` (the reference's default, also the
    plain oracle) on the CPU.

    Mamba1 archs: ``{"pos", "ssm": (conv (L, B, K-1, dI) in the compute
    dtype, h (L, B, dI, N) fp32)}``, the per-layer state a decode continues
    from (``max_len`` is unused); ``impl`` is the scan, ``"kernel"`` by
    default (K3 on CUDA, the plain scan for CPU tensors) or ``"plain"``.

    ``last_positions`` ((B,) int, optional) picks a per-row logit position.
    ``layers`` as in :func:`decode_step_paged`.
    """
    _require_ported(cfg, "prefill")
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed_tokens(cfg, params, tokens, positions)
    layers = layers or layer_views(params)
    if cfg.ssm:
        x, cache = _prefill_ssm(cfg, layers, x, impl or "kernel")
    else:
        if impl is None:
            impl = "flash" if tokens.is_cuda else "chunked"
        x, cache = _prefill_attention(cfg, layers, x, positions,
                                      max(max_len, S), impl)
    x_last = x[:, -1] if last_positions is None \
        else x[torch.arange(B, device=x.device), last_positions.long()]
    logits = _logits(cfg, params, x_last)
    cache["pos"] = S
    return logits, cache


def _prefill_attention(cfg: ModelConfig, layers, x, positions, max_len: int,
                       impl: str):
    cdt = dtype_of(cfg.compute_dtype)
    pad = max_len - x.shape[1]
    ks, vs = [], []
    for lp in layers:
        h = rms_norm(x, lp["ln1"], cfg.rms_eps)
        y, (k, v) = attention(lp, h, cfg, positions, impl=impl,
                              return_kv=True)
        x = x + y
        h2 = rms_norm(x, lp["ln2"], cfg.rms_eps)
        x = x + mlp(lp, h2, cfg)
        k = k.transpose(1, 2)                      # (B, KV, S, hd)
        v = v.transpose(1, 2)
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        ks.append(k.to(cdt))
        vs.append(v.to(cdt))
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


# ------------------------------------------------------------ slot state
def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               device=None) -> Dict[str, Any]:
    """The decode cache of a Mamba1 arch (the SSM branch of the
    reference's ``init_cache``): ``{"pos": 0, "ssm": (conv (L, batch, K-1,
    dI) in the compute dtype, h (L, batch, dI, N) fp32)}``, zeros.
    ``max_len`` is unused (an SSM's state does not grow); ``device`` None
    means CUDA. The serve engine's fixed-slot pool is this minus ``pos``."""
    _require_slots(cfg, "init_cache")
    L = cfg.num_layers
    conv, h = init_mamba_state(cfg, batch, dtype_of(cfg.compute_dtype),
                               resolve_device(device))
    return {"pos": 0,
            "ssm": (conv.unsqueeze(0).repeat(L, 1, 1, 1),
                    h.unsqueeze(0).repeat(L, 1, 1, 1))}


def decode_step_slots(cfg: ModelConfig, params, state, token, pos,
                      layers=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step over the SLOT-RESIDENT state pool of a Mamba1 arch,
    with per-row positions (the counterpart of :func:`decode_step_paged`).

    ``state`` is :func:`init_cache`'s dict minus ``pos``; its ``ssm``
    tensors are updated IN PLACE (each layer's new ``(conv, h)`` is copied
    into them) and the same dict is returned. Every op is row-wise, so a
    row's tokens do not depend on who shares the batch; inactive slots step
    on stale state harmlessly (the engine discards their tokens and
    overwrites the slot at the next admission). token: (B,) int; pos: (B,)
    int per-row position. Returns (logits (B, padded_vocab) fp32, state).
    """
    _require_slots(cfg, "slot-state decode")
    x1 = _embed_tokens(cfg, params, token, pos)
    conv, h = state["ssm"]
    for l, lp in enumerate(layers or layer_views(params)):
        x1, (conv_l, h_l) = _block_decode(lp, x1, cfg, (conv[l], h[l]),
                                          None)
        conv[l].copy_(conv_l)
        h[l].copy_(h_l)
    return _logits(cfg, params, x1), state


def decode_chunk_slots(cfg: ModelConfig, params, state, carry, n: int,
                       layers=None):
    """``n`` greedy decode steps over the slot-state pool — the Mamba1
    counterpart of :func:`decode_chunk_paged`, with the same device-resident
    ``(lengths, last, rem)`` carry. Returns ``(state, (lengths, last, rem),
    toks)`` with ``toks`` (B, n) int32."""
    _require_slots(cfg, "slot-state decode")
    layers = layers or layer_views(params)

    def step(st, tok, ln, active):
        return decode_step_slots(cfg, params, st, tok, ln, layers=layers)

    return _decode_chunk_scan(step, state, carry, n)

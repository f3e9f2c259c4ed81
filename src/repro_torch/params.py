"""Model weights of the port: a plain dict of stacked per-layer tensors with
the reference tree's names (``blocks.wq`` is ``(L, D, H*hd)``, ...).

* :func:`from_reference` converts the numpy leaves of
  ``repro.models.lm.init_params(cfg, PRNGKey(0))`` name for name — the
  parity tests' route, so both frameworks run the same weights.
* :func:`init_params` draws the same tree shapes from a ``torch.Generator``
  (its numbers differ from ``jax.random``'s).

Load-time cast: the reference casts every fp32 weight matrix to the compute
dtype at each use (``p["wq"].astype(cdt)``). Rounding once at load gives the
same bits and halves resident weights (stablelm-1.6b at full width: ~3.3 GB
bf16 instead of 6.6 GB fp32), so the matrices ``wq wk wv wo wi wg wd embed
lm_head`` are stored in the compute dtype (``from_reference(cast=False)``
keeps the reference's dtypes, for a bit-exact copy). Norm scales stay in
``param_dtype``: ``rms_norm`` upcasts the scale to fp32, and a bf16 round
trip would change it. Biases stay too (they are cast at use, as in the
reference).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ModelConfig
from .device import resolve_device
from .models.layers import dense_init, dtype_of, normal_init

__all__ = ["from_reference", "init_params", "MATRICES", "to_torch",
           "param_bytes"]

#: weight names stored in the compute dtype (the load-time cast)
MATRICES = frozenset({"wq", "wk", "wv", "wo", "wi", "wg", "wd", "embed",
                      "lm_head"})


def to_torch(x, device=None) -> torch.Tensor:
    """numpy / array-like -> torch tensor on ``device`` (CPU when None).
    ml_dtypes bfloat16 arrays, which ``torch.from_numpy`` rejects, travel as
    their uint16 bit pattern."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t if device is None else t.to(device)


def from_reference(tree: Dict[str, Any], cfg: ModelConfig, device=None,
                   cast: bool = True) -> Dict[str, Any]:
    """Convert a reference param pytree (nested dicts of arrays) into the
    port's dict, name for name; ``cast`` stores the matrices in the compute
    dtype (see module docstring). ``device`` None means CUDA."""
    dev = resolve_device(device)
    cdt = dtype_of(cfg.compute_dtype)

    def conv(node):
        out = {}
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                out[name] = conv(leaf)
                continue
            t = to_torch(leaf, dev)
            if cast and name in MATRICES:
                t = t.to(cdt)
            out[name] = t
        return out

    return conv(tree)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights with the reference tree's names and shapes, drawn on
    the generator's device and moved to ``device`` (None: CUDA); matrices
    in the compute dtype, norm scales and biases in ``param_dtype``. Dense
    attention families only (MoE, SSM and hybrid trees come with their
    slices)."""
    if cfg.moe or cfg.ssm or cfg.hybrid_attn_every:
        raise ValueError(f"{cfg.name}: repro_torch.init_params covers dense "
                         "attention configs only (family "
                         f"{cfg.family!r} is not ported yet)")
    dev = resolve_device(device)
    pdt = dtype_of(cfg.param_dtype)
    mdt = dtype_of(cfg.compute_dtype)
    g = generator
    L, D, H, KV, hd = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                       cfg.num_kv_heads, cfg.hd)
    Vp = cfg.padded_vocab

    def dense(shape):   # per-layer init stacked over L, as the vmapped ref
        return torch.stack([dense_init(g, shape, mdt) for _ in range(L)]
                           ).to(dev)

    def const(shape, value):
        return torch.full(shape, value, dtype=pdt, device=dev)

    blocks: Dict[str, torch.Tensor] = {
        "ln1": const((L, D), 1.0),
        "wq": dense((D, H * hd)),
        "wk": dense((D, KV * hd)),
        "wv": dense((D, KV * hd)),
        "wo": dense((H * hd, D)),
    }
    if cfg.qkv_bias:
        blocks["bq"] = const((L, H * hd), 0.0)
        blocks["bk"] = const((L, KV * hd), 0.0)
        blocks["bv"] = const((L, KV * hd), 0.0)
    if cfg.qk_norm:
        blocks["q_norm"] = const((L, hd), 1.0)
        blocks["k_norm"] = const((L, hd), 1.0)
    blocks["ln2"] = const((L, D), 1.0)
    blocks["wi"] = dense((D, cfg.d_ff))
    if cfg.mlp_gated:
        blocks["wg"] = dense((D, cfg.d_ff))
    blocks["wd"] = dense((cfg.d_ff, D))
    params: Dict[str, Any] = {
        "embed": normal_init(g, (Vp, D), 0.02, mdt).to(dev),
        "final_norm": const((D,), 1.0),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(g, (D, Vp), 0.02, mdt).to(dev)
    return params


def param_bytes(params: Dict[str, Any]) -> int:
    """Resident bytes of a param dict (nested)."""
    n = 0
    for v in params.values():
        n += param_bytes(v) if isinstance(v, dict) \
            else v.numel() * v.element_size()
    return n

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
lm_head`` and the Mamba1 leaves the reference casts the same way
(``in_proj x_proj dt_proj out_proj conv_w conv_b``) are stored in the
compute dtype (``from_reference(cast=False)`` keeps the reference's dtypes,
for a bit-exact copy). Norm scales stay in ``param_dtype``: ``rms_norm``
upcasts the scale to fp32, and a bf16 round trip would change it. Biases
stay too (they are cast at use, as in the reference), and so do the Mamba1
leaves read in fp32: ``A_log`` and ``ssm_D`` (fp32 in the tree) and
``dt_bias`` (upcast at use).
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
                      "lm_head", "in_proj", "x_proj", "dt_proj", "out_proj",
                      "conv_w", "conv_b"})


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
    attention and Mamba1 (falcon-mamba) families; MoE and Mamba2/hybrid
    trees come with their slices."""
    if cfg.moe or cfg.hybrid_attn_every or (cfg.ssm and cfg.ssm_version != 1):
        raise ValueError(f"{cfg.name}: repro_torch.init_params covers dense "
                         "attention and Mamba1 configs only (family "
                         f"{cfg.family!r} is not ported yet)")
    dev = resolve_device(device)
    pdt = dtype_of(cfg.param_dtype)
    mdt = dtype_of(cfg.compute_dtype)
    g = generator
    L, D = cfg.num_layers, cfg.d_model
    Vp = cfg.padded_vocab

    def stacked(draw, shape, dtype):
        # per-layer draws stacked over L, as the vmapped ref; filled layer
        # by layer so the peak is one stack, not a list plus its stack
        out = torch.empty((L, *shape), dtype=dtype, device=dev)
        for l in range(L):
            out[l] = draw()
        return out

    def dense(shape):
        return stacked(lambda: dense_init(g, shape, mdt), shape, mdt)

    def const(shape, value, dtype=pdt):
        return torch.full(shape, value, dtype=dtype, device=dev)

    if cfg.ssm:
        blocks = _init_m1(cfg, g, dev, stacked, dense, const, pdt, mdt)
    else:
        blocks = _init_attention_mlp(cfg, dense, const)
    params: Dict[str, Any] = {
        "embed": normal_init(g, (Vp, D), 0.02, mdt).to(dev),
        "final_norm": const((D,), 1.0),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(g, (D, Vp), 0.02, mdt).to(dev)
    return params


def _init_attention_mlp(cfg: ModelConfig, dense, const
                        ) -> Dict[str, torch.Tensor]:
    """A dense attention + MLP layer stack (the reference's ``_init_block``
    for attention archs)."""
    L, D, H, KV, hd = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                       cfg.num_kv_heads, cfg.hd)
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
    return blocks


def _init_m1(cfg: ModelConfig, g: torch.Generator, dev: torch.device,
             stacked, dense, const, pdt, mdt) -> Dict[str, torch.Tensor]:
    """A Mamba1 layer stack with ``ln1`` and the reference ``_init_m1``'s
    names, shapes and distributions (``repro.models.mamba``)."""
    L, D = cfg.num_layers, cfg.d_model
    dI, N, R, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.ssm_conv

    def dt_bias():   # softplus^-1 of U(1e-3, 1e-1)
        u = torch.rand((dI,), generator=g, device=g.device) \
            * (1e-1 - 1e-3) + 1e-3
        return torch.log(torch.expm1(u)).to(pdt)

    # A_log and ssm_D are fp32 whatever param_dtype is, as in the reference
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(dI, 1)
    return {
        "ln1": const((L, D), 1.0),
        "in_proj": dense((D, 2 * dI)),
        "conv_w": stacked(lambda: normal_init(g, (dI, K), 0.2, mdt),
                          (dI, K), mdt),
        "conv_b": const((L, dI), 0.0, mdt),
        "x_proj": dense((dI, R + 2 * N)),
        "dt_proj": stacked(lambda: normal_init(g, (R, dI), R ** -0.5, mdt),
                           (R, dI), mdt),
        "dt_bias": stacked(dt_bias, (dI,), pdt),
        "A_log": torch.log(A).repeat(L, 1, 1),
        "ssm_D": const((L, dI), 1.0, torch.float32),
        "out_proj": dense((dI, D)),
    }


def param_bytes(params: Dict[str, Any]) -> int:
    """Resident bytes of a param dict (nested)."""
    n = 0
    for v in params.values():
        n += param_bytes(v) if isinstance(v, dict) \
            else v.numel() * v.element_size()
    return n

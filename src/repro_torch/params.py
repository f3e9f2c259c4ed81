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
lm_head``, the Mamba leaves the reference casts the same way (``in_proj
x_proj dt_proj out_proj conv_w conv_b``), zamba2's shared-block
``fused_proj`` and the MoE expert, shared-expert and dense-residual
matrices (``e_wi e_wg e_wd shared_w* dense_w*``) are stored in the compute
dtype (``from_reference(cast=False)``
keeps the reference's dtypes, for a bit-exact copy). Norm scales stay in
``param_dtype`` (Mamba2's gated-norm ``ssm_norm`` too): ``rms_norm``
upcasts the scale to fp32, and a bf16 round trip would change it. Biases
stay too (they are cast at use, as in the reference), and so do the Mamba
leaves read in fp32: ``A_log`` and ``ssm_D`` (fp32 in the tree) and
``dt_bias`` (upcast at use; fp32 in the Mamba2 tree), and the MoE leaves
read in fp32: ``router`` (fp32 in the tree) and ``shared_gate``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ModelConfig
from .device import resolve_device
from .models.layers import dense_init, dtype_of, normal_init
from .models.moe import init_moe

__all__ = ["from_reference", "init_params", "MATRICES", "to_torch",
           "param_bytes"]

#: weight names stored in the compute dtype (the load-time cast)
MATRICES = frozenset({"wq", "wk", "wv", "wo", "wi", "wg", "wd", "embed",
                      "lm_head", "in_proj", "x_proj", "dt_proj", "out_proj",
                      "conv_w", "conv_b", "fused_proj", "e_wi", "e_wg",
                      "e_wd", "shared_wi", "shared_wg", "shared_wd",
                      "dense_wi", "dense_wg", "dense_wd"})


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
                device=None, cast: bool = True) -> Dict[str, Any]:
    """Random weights with the reference tree's names and shapes, drawn on
    the generator's device and moved to ``device`` (None: CUDA); matrices
    in the compute dtype, norm scales and biases in ``param_dtype``
    (``cast=False``: every leaf in ``param_dtype``, the fp32 masters a
    trainer updates; the draws are the same, only not rounded). Dense
    attention, MoE (the FFN's leaves from :func:`repro_torch.models.moe.
    init_moe`, ``router`` fp32), Mamba1 (falcon-mamba) and the Mamba2
    hybrid (zamba2: ``gblocks`` stacked (G, every, ...), ``tail_blocks``
    (tail, ...) and one ``shared_block``). The ``padded_vocab -
    vocab_size`` padded rows of ``embed`` and columns of ``lm_head`` are
    zero."""
    dev = resolve_device(device)
    pdt = dtype_of(cfg.param_dtype)
    mdt = dtype_of(cfg.compute_dtype) if cast else pdt
    g = generator
    D, Vp = cfg.d_model, cfg.padded_vocab

    def layer_stack(n: int) -> Dict[str, torch.Tensor]:
        """``n`` layers' leaves, each stacked over a leading axis of n."""
        def stacked(draw, shape, dtype):
            # per-layer draws stacked, as the vmapped ref; filled layer by
            # layer so the peak is one stack, not a list plus its stack
            out = torch.empty((n, *shape), dtype=dtype, device=dev)
            for l in range(n):
                out[l] = draw()
            return out

        def dense(shape):
            return stacked(lambda: dense_init(g, shape, mdt), shape, mdt)

        def const(shape, value, dtype=pdt):
            return torch.full((n, *shape), value, dtype=dtype, device=dev)

        if cfg.moe:
            # one layer's MoE leaves at a time, each written into its stack
            blocks = _init_attention_mlp(cfg, dense, const)
            for l in range(n):
                for k, v in init_moe(g, cfg, dev, cast).items():
                    if k not in blocks:
                        blocks[k] = torch.empty((n, *v.shape),
                                                dtype=v.dtype, device=dev)
                    blocks[k][l] = v
            return blocks
        if not cfg.ssm:
            return _init_attention_mlp(cfg, dense, const)
        init = _init_m1 if cfg.ssm_version == 1 else _init_m2
        return {"ln1": const((D,), 1.0),
                **init(cfg, g, stacked, dense, const, pdt, mdt)}

    every = cfg.hybrid_attn_every
    stacks: Dict[str, Any] = {}
    if every:
        G, tail = divmod(cfg.num_layers, every)
        stacks["gblocks"] = {k: v.reshape(G, every, *v.shape[1:])
                             for k, v in layer_stack(G * every).items()}
        if tail:
            stacks["tail_blocks"] = layer_stack(tail)
        stacks["shared_block"] = _init_shared_block(cfg, g, dev, pdt, mdt)
    else:
        stacks["blocks"] = layer_stack(cfg.num_layers)
    params: Dict[str, Any] = {
        "embed": normal_init(g, (Vp, D), 0.02, mdt).to(dev),
        "final_norm": torch.ones((D,), dtype=pdt, device=dev),
        **stacks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(g, (D, Vp), 0.02, mdt).to(dev)
        params["lm_head"][:, cfg.vocab_size:] = 0
    # the padded vocabulary's rows and columns are zero, as in a checkpoint
    # padded at load: the logits stay unmasked (as the reference's), and a
    # padded id then never wins the greedy argmax over random real ones
    params["embed"][cfg.vocab_size:] = 0
    return params


def _init_attention_mlp(cfg: ModelConfig, dense, const
                        ) -> Dict[str, torch.Tensor]:
    """A dense attention + MLP layer stack (the reference's ``_init_block``
    for attention archs; an MoE arch's stack gets its FFN from
    ``init_moe`` instead of the MLP)."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    blocks: Dict[str, torch.Tensor] = {
        "ln1": const((D,), 1.0),
        "wq": dense((D, H * hd)),
        "wk": dense((D, KV * hd)),
        "wv": dense((D, KV * hd)),
        "wo": dense((H * hd, D)),
    }
    if cfg.qkv_bias:
        blocks["bq"] = const((H * hd,), 0.0)
        blocks["bk"] = const((KV * hd,), 0.0)
        blocks["bv"] = const((KV * hd,), 0.0)
    if cfg.qk_norm:
        blocks["q_norm"] = const((hd,), 1.0)
        blocks["k_norm"] = const((hd,), 1.0)
    blocks["ln2"] = const((D,), 1.0)
    if cfg.moe:
        return blocks
    blocks["wi"] = dense((D, cfg.d_ff))
    if cfg.mlp_gated:
        blocks["wg"] = dense((D, cfg.d_ff))
    blocks["wd"] = dense((cfg.d_ff, D))
    return blocks


def _softplus_inv_uniform(g: torch.Generator, n: int) -> torch.Tensor:
    """softplus^-1 of U(1e-3, 1e-1), fp32: the reference's ``dt_bias``."""
    u = torch.rand((n,), generator=g, device=g.device) * (1e-1 - 1e-3) + 1e-3
    return torch.log(torch.expm1(u))


def _init_m1(cfg: ModelConfig, g: torch.Generator, stacked, dense, const,
             pdt, mdt) -> Dict[str, torch.Tensor]:
    """A Mamba1 layer stack with the reference ``_init_m1``'s names, shapes
    and distributions (``repro.models.mamba``), without ``ln1``."""
    D = cfg.d_model
    dI, N, R, K = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_, cfg.ssm_conv
    # A_log and ssm_D are fp32 whatever param_dtype is, as in the reference
    A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32)
                      ).repeat(dI, 1)
    return {
        "in_proj": dense((D, 2 * dI)),
        "conv_w": stacked(lambda: normal_init(g, (dI, K), 0.2, mdt),
                          (dI, K), mdt),
        "conv_b": const((dI,), 0.0, mdt),
        "x_proj": dense((dI, R + 2 * N)),
        "dt_proj": stacked(lambda: normal_init(g, (R, dI), R ** -0.5, mdt),
                           (R, dI), mdt),
        "dt_bias": stacked(lambda: _softplus_inv_uniform(g, dI).to(pdt),
                           (dI,), pdt),
        "A_log": stacked(lambda: A_log, (dI, N), torch.float32),
        "ssm_D": const((dI,), 1.0, torch.float32),
        "out_proj": dense((dI, D)),
    }


def _init_m2(cfg: ModelConfig, g: torch.Generator, stacked, dense, const,
             pdt, mdt) -> Dict[str, torch.Tensor]:
    """A Mamba2 layer stack with the reference ``_init_m2``'s names, shapes
    and distributions, without ``ln1``; ``A_log``, ``dt_bias`` and
    ``ssm_D`` are fp32 as there."""
    D, dI, N, K, nh = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                       cfg.ssm_heads)
    conv_dim = dI + 2 * N
    A_log = torch.log(torch.linspace(1.0, 16.0, nh))
    return {
        "in_proj": dense((D, 2 * dI + 2 * N + nh)),
        "conv_w": stacked(lambda: normal_init(g, (conv_dim, K), 0.2, mdt),
                          (conv_dim, K), mdt),
        "conv_b": const((conv_dim,), 0.0, mdt),
        "A_log": stacked(lambda: A_log, (nh,), torch.float32),
        "dt_bias": stacked(lambda: _softplus_inv_uniform(g, nh), (nh,),
                           torch.float32),
        "ssm_D": const((nh,), 1.0, torch.float32),
        "ssm_norm": const((dI,), 1.0),
        "out_proj": dense((dI, D)),
    }


def _init_shared_block(cfg: ModelConfig, g: torch.Generator, dev, pdt, mdt
                       ) -> Dict[str, torch.Tensor]:
    """zamba2's one shared transformer block (the reference's
    ``_init_shared_block``): the (2D, D) concat in-projection, two norms,
    attention and a gated MLP."""
    D, H, KV, hd, Fd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                        cfg.d_ff)

    def dense(shape):
        return dense_init(g, shape, mdt).to(dev)

    def ones():
        return torch.ones((D,), dtype=pdt, device=dev)

    return {"fused_proj": dense((2 * D, D)), "ln1": ones(), "ln2": ones(),
            "wq": dense((D, H * hd)), "wk": dense((D, KV * hd)),
            "wv": dense((D, KV * hd)), "wo": dense((H * hd, D)),
            "wi": dense((D, Fd)), "wg": dense((D, Fd)), "wd": dense((Fd, D))}


def param_bytes(params: Dict[str, Any]) -> int:
    """Resident bytes of a param dict (nested)."""
    n = 0
    for v in params.values():
        n += param_bytes(v) if isinstance(v, dict) \
            else v.numel() * v.element_size()
    return n

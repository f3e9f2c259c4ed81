"""Weights and training tokens made from ``--seed``, on the device.

A family's reference module lists its leaves (:func:`shapes`' entries:
``name -> (shape, init, matrix)``) in the layout that
``repro_torch.params`` documents (``embed``, ``lm_head``, ``final_norm``
and per-layer stacks under ``blocks``). Each leaf is drawn in ONE call from
its own ``torch.Generator`` on the device, seeded from ``(seed, name)``, so
any leaf can be drawn again alone (the training check redraws the initial
weights leaf by leaf). Served weights hold their matrices in bfloat16, the
type they are served in, and the rest in float32; training weights are
float32 masters. The program and the reference are handed the same
tensors.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict

import numpy as np
import torch


def leaf_seed(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def draw(shape, init, dtype, seed: int, name: str, device) -> torch.Tensor:
    """One leaf. ``init``: ``("normal", std)``, ``("const", value)``,
    ``("uniform_softplus_inv", lo, hi)`` (the inverse softplus of U(lo,
    hi)) or ``("log_arange", n)`` (log 1..n along the last axis)."""
    kind = init[0]
    if kind == "const":
        return torch.full(shape, float(init[1]), dtype=dtype, device=device)
    if kind == "log_arange":
        row = torch.log(torch.arange(1, init[1] + 1, dtype=torch.float32,
                                     device=device))
        return row.expand(*shape).to(dtype).contiguous()
    g = torch.Generator(device=device).manual_seed(leaf_seed(seed, name))
    if kind == "normal":
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(init[1])
    if kind == "uniform_softplus_inv":
        lo, hi = init[1], init[2]
        u = torch.rand(shape, generator=g, device=device,
                       dtype=torch.float32) * (hi - lo) + lo
        return torch.log(torch.expm1(u)).to(dtype)
    raise ValueError(f"unknown init {init!r}")


def make(shapes: Dict[str, tuple], seed: int, device, served: bool,
         vocab: int) -> Dict[str, torch.Tensor]:
    """Every leaf, flat by dotted name. The padded vocabulary's rows of
    ``embed`` and columns of ``lm_head`` (past ``vocab``) are zero."""
    out = {}
    for name, (shape, init, matrix) in shapes.items():
        dtype = torch.bfloat16 if (served and matrix) else torch.float32
        out[name] = draw(shape, init, dtype, seed, name, device)
    zero_padding(out, vocab)
    return out


def zero_padding(flat: Dict[str, torch.Tensor], vocab: int) -> None:
    if "embed" in flat and flat["embed"].shape[0] > vocab:
        flat["embed"][vocab:] = 0
    if "lm_head" in flat and flat["lm_head"].shape[1] > vocab:
        flat["lm_head"][:, vocab:] = 0


def tree(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Dotted names -> the nested dict of ``repro_torch.params``."""
    out: Dict[str, Any] = {}
    for name, t in flat.items():
        node = out
        *path, last = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = t
    return out


def flatten(tree_: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree_.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def fan_in(shape) -> float:
    """LeCun normal's scale for a (..., in, out) matrix stack."""
    return 1.0 / math.sqrt(max(1, shape[-2]))


def rng(seed: int, *key: int) -> np.random.Generator:
    """numpy's generator for ``(seed, *key)``; any whole seed."""
    return np.random.default_rng([seed % (1 << 64), *key])

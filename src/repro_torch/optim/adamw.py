"""AdamW with global-norm clipping, decoupled weight decay and a
configurable moment dtype (torch port of ``repro.optim.adamw``).

The arithmetic is the reference's, leaf for leaf: the clip scale
``min(1, clip / (gnorm + 1e-9))``, bias corrections from the incremented
``count``, weight decay only on leaves with ``ndim >= 2``, moments stored
in ``moment_dtype``. The learning rate and the clip scale stay 0-d tensors
on the params' device, so a step reads nothing back to the host.

The update is made IN PLACE: the reference's jitted step donates its
params and moments, and at full width (stablelm-1.6b: 6.6 GB of fp32
masters, 13.2 GB of moments) a second copy would not be free. The
returned trees are the ones passed in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.layers import dtype_of
from ..tree import leaves, tree_map

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "lr_at",
           "global_norm"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # bfloat16 for very large models


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``; fp32 0-d tensor
    (on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(
        1.0, cfg.total_steps - cfg.warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any, cfg: OptConfig) -> Dict[str, Any]:
    dt = dtype_of(cfg.moment_dtype)
    first = leaves(params)[0]
    return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "v": tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=first.device)}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: OptConfig) -> Tuple[Any, Dict[str, Any],
                                          Dict[str, Any]]:
    """One AdamW step, in place on ``params`` and ``state["m"/"v"]``.
    Returns ``(params, {"m", "v", "count"}, {"grad_norm", "lr"})``."""
    count = state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, count)
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, c)
    bc2 = 1.0 - torch.pow(cfg.b2, c)

    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(state["m"]), leaves(state["v"])):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * torch.square(g)
        del g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        p32 = p.float()
        if p.ndim >= 2:
            step = step + cfg.weight_decay * p32
        p.copy_(p32 - lr * step)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        metrics

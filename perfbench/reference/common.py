"""Pieces the plain references share: plain PyTorch in float32 with TF32
off, no kernel of the program, no cache, no batching of requests.

``precision="fp8"`` is the control of ``correct``: every matrix product's
operands are rounded to float8 (e4m3: the activations per row, the weights
per output column, each scaled to the format's range) and multiplied in
float32; the rest stays float32. Its gradient passes the rounding straight
through.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.utils.checkpoint

FP8_MAX = 448.0


def fp32_mode() -> None:
    """No TF32 in float32 products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) \
        / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in float32 (``b`` a weight, (in, out))."""
    a, b = a.float(), b.float()
    if precision == "fp8":
        a, b = _fp8(a, -1), _fp8(b, -2)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return a @ b


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), exact at every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """Mean next-token cross-entropy over the real vocabulary (padded
    columns masked) plus 1e-4 * mean(logz^2), in float32."""
    if logits.shape[-1] > vocab:
        logits = logits.masked_fill(
            torch.arange(logits.shape[-1], device=logits.device) >= vocab,
            -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold) + 1e-4 * torch.mean(logz.square())


def lr_at(opt: Dict, count: int) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``."""
    w, T = opt["warmup_steps"], opt["total_steps"]
    if count < w:
        return opt["lr"] * count / max(1.0, w)
    prog = min(1.0, max(0.0, (count - w) / max(1.0, T - w)))
    return opt["lr"] * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"])
                        * 0.5 * (1 + math.cos(math.pi * prog)))


def train(loss_of: Callable, params: Dict[str, torch.Tensor],
          batches: List[torch.Tensor], opt: Dict, microbatches: int):
    """AdamW with global-norm clipping and decoupled weight decay (on
    leaves of two or more dimensions), one step a batch, the gradient the
    mean over the batch's microbatches. ``params``: float32 leaves,
    updated in place. Returns (the losses, each leaf's first gradient as
    the optimizer takes it (clipped) by its norm)."""
    names = list(params)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], {}
    for i, batch in enumerate(batches):
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        total = 0.0
        for mb in batch.chunk(microbatches):
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in params.items()}
            loss = loss_of(leaves, mb)
            gs = torch.autograd.grad(loss, [leaves[n] for n in names])
            for n, g in zip(names, gs):
                grads[n].add_(g / microbatches)
            total += float(loss.detach()) / microbatches
            del gs, loss, leaves
        losses.append(total)
        gnorm = math.sqrt(sum(float(g.norm()) ** 2 for g in grads.values()))
        scale = min(1.0, opt["clip_norm"] / (gnorm + 1e-9))
        count = i + 1
        lr = lr_at(opt, count)
        bc1 = 1 - opt["b1"] ** count
        bc2 = 1 - opt["b2"] ** count
        with torch.no_grad():
            for n in names:
                g = grads[n].mul_(scale)
                if i == 0:
                    first[n] = float(g.norm())
                m[n].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[n].mul_(opt["b2"]).add_(g.square(), alpha=1 - opt["b2"])
                step = (m[n] / bc1) / ((v[n] / bc2).sqrt() + opt["eps"])
                if params[n].dim() >= 2:
                    step = step + opt["weight_decay"] * params[n]
                params[n].sub_(lr * step)
        del grads
    return losses, first


def checkpointed(fn, *args):
    """``fn(*args)`` recomputed in the backward: one layer's activations
    live at a time."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


__all__ = ["fp32_mode", "round_up", "mm", "rms_norm", "softplus",
           "logits_loss", "lr_at", "train", "checkpointed"]

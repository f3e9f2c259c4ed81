"""Gradient compression with error feedback (torch port of
``repro.optim.compress``).

int8 per-tensor-scale quantisation of the gradients with a bf16 error
state that re-injects each step's quantisation error into the next
(Seide et al. / EF-SGD). ``compress_grads`` returns what a compressed
all-reduce would hand back when it reduces dequantised values.
``torch.round`` rounds half to even, as ``jnp.round`` does.

Under a mesh (``group``: this rank's ``MeshGroup``; the gradients and the
error state are this rank's blocks) each tensor's ``amax`` is the whole
tensor's: one all-reduce of every leaf's local maximum, so each block is
quantised on the scale the unsharded tensor would get.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..tree import leaves, unflatten

__all__ = ["init_error_state", "compress_grads"]


def init_error_state(params: Any) -> Any:
    return unflatten(params, [torch.zeros_like(p, dtype=torch.bfloat16)
                              for p in leaves(params)])


def _quantize(x: torch.Tensor, amax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = (torch.max(torch.abs(x)) if amax is None else amax) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compress_grads(grads: Any, err: Any, group=None) -> Tuple[Any, Any]:
    """Returns (dequantised grads as seen after the all-reduce, the new
    error state)."""
    pairs = list(zip(leaves(grads), leaves(err)))
    amax = [None] * len(pairs)
    if group is not None:     # a first pass for the whole tensors' amax
        amax = group.all_reduce(torch.stack([
            torch.max(torch.abs(g.float() + e.float())) for g, e in pairs]),
            op="max")
    out_g, out_e = [], []
    for (g, e), a in zip(pairs, amax):
        g32 = g.float() + e.float()
        q, scale = _quantize(g32, a)
        deq = q.float() * scale
        out_g.append(deq.to(g.dtype))
        out_e.append((g32 - deq).to(torch.bfloat16))
    return unflatten(grads, out_g), unflatten(grads, out_e)

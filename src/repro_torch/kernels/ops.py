"""Public dispatch for the port's kernels.

A CUDA tensor launches the hand-written kernel, a CPU tensor takes its
plain PyTorch version (see each kernel module). :func:`default_paged_impl`
resolves the serve engine's paged decode read path, the counterpart of
``repro.kernels.ops.default_paged_impl`` with the port's names:

* ``"kernel"`` (the JAX ``"pallas"``): K1 on CUDA, its plain page loop on
  the CPU;
* ``"loop"``   (the JAX ``"xla"``): the plain page loop on any device;
* ``"gather"`` (the same name): the materialize-then-mask oracle in
  :func:`repro_torch.serve.kvcache.gather_read_attention`.

``REPRO_PAGED_IMPL`` wins when set; otherwise ``"kernel"`` when the pool is
on CUDA and ``"loop"`` on the CPU.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from . import flash_attention as _flash_mod
from . import lsdnn_layer as _lsdnn_mod
from . import mamba_scan as _scan_mod
from . import mamba_scan_bwd as _scan_bwd_mod
from . import paged_attention as _paged_mod
from ._build import build_info, ensure_built
from .ref import paged_attention_ref

__all__ = ["PAGED_IMPLS", "default_paged_impl", "paged_attention",
           "flash_attention", "mamba_scan",
           "lsdnn_layer", "ensure_built",
           "build_info",
           "launch_counts", "reset_launch_counts", "add_launches"]

PAGED_IMPLS = ("kernel", "loop", "gather")


def default_paged_impl(device: Optional[torch.device] = None) -> str:
    env = os.environ.get("REPRO_PAGED_IMPL", "").strip().lower()
    if env:
        if env not in PAGED_IMPLS:
            raise ValueError(
                f"REPRO_PAGED_IMPL={env!r}: expected one of {PAGED_IMPLS}")
        return env
    return "kernel" if device is not None and torch.device(device).type \
        == "cuda" else "loop"


def paged_attention(q, pool_kv, tables, lengths, impl: str = "kernel"):
    """``impl="kernel"``: K1 (plain loop for CPU tensors); ``"loop"``: the
    plain page loop. The ``"gather"`` oracle lives in the kvcache module."""
    if impl == "kernel":
        return _paged_mod.paged_attention(q, pool_kv, tables, lengths)
    if impl == "loop":
        return paged_attention_ref(q, pool_kv, tables, lengths)
    raise ValueError(f"unknown paged attention impl {impl!r} "
                     "(expected 'kernel' or 'loop')")


def flash_attention(q, k, v, causal: bool = True):
    return _flash_mod.flash_attention(q, k, v, causal=causal)


def mamba_scan(dt, x, Bc, Cc, A, h0=None):
    """K3 (with the backward kernel behind it when autograd records) on
    CUDA, the plain scan on the CPU; see the kernel module."""
    return _scan_mod.mamba_scan(dt, x, Bc, Cc, A, h0=h0)


def lsdnn_layer(y, w, b, cap: float = 32.0):
    return _lsdnn_mod.lsdnn_layer(y, w, b, cap=cap)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel. A wrapper counts
    when it is called, one for each kernel it launches (two for K3's
    backward: the reverse scan and its sums), so a launch recorded into a CUDA graph counts once,
    at capture, unless the graph's owner moves the count to its replays:
    the serve engine's captured decode chunk
    (:class:`repro_torch.serve.chunk_graph.ChunkProgram`) takes back the
    capture's counts and adds them again at every replay
    (:func:`add_launches`), since each replay launches those kernels."""
    return {"paged_attention": _paged_mod.launches,
            "flash_attention": _flash_mod.launches,
            "mamba_scan": _scan_mod.launches,
            "mamba_scan_bwd": _scan_bwd_mod.launches,
            "lsdnn_layer": _lsdnn_mod.launches}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches, the keys of
    :func:`launch_counts`; negative to take a capture's counts back)."""
    mods = {"paged_attention": _paged_mod, "flash_attention": _flash_mod,
            "mamba_scan": _scan_mod, "mamba_scan_bwd": _scan_bwd_mod,
            "lsdnn_layer": _lsdnn_mod}
    for name, n in counts.items():
        mods[name].launches += n


def reset_launch_counts() -> None:
    _paged_mod.launches = 0
    _flash_mod.launches = 0
    _scan_mod.launches = 0
    _scan_bwd_mod.launches = 0
    _lsdnn_mod.launches = 0

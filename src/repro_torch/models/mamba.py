"""Mamba1 (selective scan) and Mamba2 (SSD) blocks of the port: the
counterpart of ``repro.models.mamba``, same signatures and layouts on torch
tensors.

Mamba1 (falcon-mamba):

* :func:`mamba_forward` (prefill and training) runs the whole sequence
  through ONE selective scan, :func:`repro_torch.kernels.ops.mamba_scan`:
  K3 on CUDA (with the backward kernel behind it when autograd records),
  its plain sequential version on the CPU (differentiated by autograd).
  The reference runs ``_m1_scan``
  instead, an associative scan inside chunks of ``ssm_chunk`` steps linked
  by a ``lax.scan`` carry; the chunks bound XLA's O(chunk * dI * N)
  activation memory. The kernel keeps each state in a register for the
  whole sequence and needs no chunks, so ``ssm_chunk`` and
  ``ssm_scan_constrain`` are unused here. The two orders of summation differ
  by fp32 rounding only.
* :func:`mamba_step` (decode) is the single-token recurrence on the carried
  ``(conv_buf, h)``.
* Under the partitioned train step a rank runs ``dI / tp`` channels:
  ``in_proj`` and ``dt_proj`` column-parallel (the step brings ``in_proj``
  as ``[x_r | z_r]``, :func:`repro_torch.distributed.sharding.
  exchange_fused`), the per-channel leaves its blocks, ``x_proj`` and
  ``out_proj`` row-parallel (so dt/B/C are summed over ``tp`` and enter
  the region again), and the scan (K3 and its backward) on ``(B, S, dI /
  tp)``.

Mamba2 (zamba2): :func:`_ssd_scan` is the reference's SSD dual form in
plain torch (no TPU kernel computes it; training differentiates it with
autograd): inside a chunk the scalar-per-head
decay turns the recurrence into a masked, decayed "attention" of C against
B, and a carried state links the chunks. The chunk rule is the
reference's: ``chunk = min(ssm_chunk, S)``, and a ragged S runs as ONE
chunk, whose (B, S, S, nh) fp32 temporaries grow with S squared.
:func:`_m2_step` is the per-head recurrence the dual form stands for.
The decode steps of both are partitioned as their forwards are in a
sharded serve step (:mod:`repro_torch.train.train_step`), where a fused
``in_proj`` may come as the rank's stored block with its product
exchanged instead (:func:`repro_torch.distributed.sharding.
fused_product`).
Under the partitioned train step a rank runs ``nh / tp`` heads
(:func:`_m2_forward`): ``out_proj`` row-parallel, the gated norm's mean
of squares summed over ``tp``, B and C whole on every rank.

A prompt shorter than ``ssm_conv - 1`` tokens leaves a conv tail with fewer
than K-1 rows in the reference (which then fails to seat it in its
fixed-slot pool); here the tail is left-padded with zeros, the buffer a
token-by-token decode from :func:`init_mamba_state` would hold. The
reference's ``constrain`` sharding hooks are identities off a mesh and are
dropped.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.sharding import fused_product, tp_part
from ..kernels import ops
from ..kernels.ref import mamba_scan_ref
from .layers import (column_parallel, dtype_of, rms_norm, row_parallel,
                     tp_copy)

__all__ = ["mamba_forward", "mamba_step", "init_mamba_state", "SCAN_IMPLS"]

#: Mamba1 prefill scan paths: ``"kernel"`` (K3 on CUDA, the plain scan on
#: the CPU) and ``"plain"`` (the plain sequential scan on any device)
SCAN_IMPLS = ("kernel", "plain")


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. x: (B, S, C); w: (C, K); b: (C,)."""
    S = x.shape[1]
    K = w.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = xp[:, 0:S] * w[:, 0]
    for k in range(1, K):
        y = y + xp[:, k:k + S] * w[:, k]
    return y + b


def _conv_step(buf: torch.Tensor, x1: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token conv. buf: (B, K-1, C) past inputs; x1: (B, C)."""
    window = torch.cat([buf, x1[:, None, :]], dim=1)          # (B, K, C)
    y = torch.einsum("bkc,ck->bc", window, w) + b
    return y, window[:, 1:, :]


def _conv_tail(x_in: torch.Tensor, K: int) -> torch.Tensor:
    """The last K-1 pre-conv inputs of x_in (B, S, C), left-padded with
    zeros when S < K-1 (the reference recomputes this slice of the
    in-projection; here it is read off the projection already made)."""
    tail = x_in[:, -(K - 1):, :]
    S = x_in.shape[1]
    return F.pad(tail, (0, 0, K - 1 - S, 0)) if S < K - 1 else tail


def _require_ssm(cfg: ModelConfig) -> None:
    if not cfg.ssm or cfg.ssm_version not in (1, 2):
        raise ValueError(f"{cfg.name}: not a Mamba1 or Mamba2 config "
                         f"(ssm={cfg.ssm}, ssm_version={cfg.ssm_version})")


# ===================================================================== Mamba1
def _m1_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                return_state: bool = False, impl: str = "kernel"):
    N, R, K = cfg.ssm_state, cfg.dt_rank_, cfg.ssm_conv
    cdt = dtype_of(cfg.compute_dtype)
    (xz,) = column_parallel(x, p["in_proj"].to(cdt), kind="mamba")
    xz = fused_product(xz, cfg, "xz")
    x_in, z = xz.split(xz.shape[-1] // 2, dim=-1)   # dI (dI / tp) each
    xh = F.silu(_causal_conv(x_in, p["conv_w"].to(cdt),
                             p["conv_b"].to(cdt)))
    proj = tp_copy(row_parallel(xh, p["x_proj"].to(cdt), kind="mamba"),
                   kind="mamba")
    dtr, Bc, Cc = proj.split([R, N, N], dim=-1)
    # jax.nn.softplus is logaddexp(x, 0); torch's softplus returns x itself
    # above threshold=20, where the dropped log1p(exp(-x)) is below 2.1e-9
    # (1.1e-10 of x, far below fp32's resolution there)
    dt = F.softplus(dtr @ p["dt_proj"].to(cdt)
                    + p["dt_bias"].float())                  # (B,S,dI) f32
    A = -torch.exp(p["A_log"].float())                       # (dI,N) f32
    if impl == "kernel":
        y, hT = ops.mamba_scan(dt, xh, Bc.contiguous(),
                               Cc.contiguous(), A, h0=h0)
    elif impl == "plain":
        y, hT = mamba_scan_ref(dt, A, Bc, Cc, xh, h0=h0)
    else:
        raise ValueError(f"unknown scan impl {impl!r} (expected one of "
                         f"{SCAN_IMPLS})")
    y = y + p["ssm_D"].float() * xh.float()
    y = y.to(cdt) * F.silu(z)
    out = row_parallel(y, p["out_proj"].to(cdt), kind="mamba")
    if return_state:
        return out, (_conv_tail(x_in, K), hT)
    return out


def _m1_step(p, x1: torch.Tensor, cfg: ModelConfig, state):
    """x1: (B, D); state = (conv_buf (B, K-1, dI), h (B, dI, N)). In a
    sharded serve step partitioned as :func:`_m1_forward` is: the state
    and every per-channel product on the rank's ``dI / tp`` channels."""
    conv_buf, h = state
    cdt = dtype_of(cfg.compute_dtype)
    N, R = cfg.ssm_state, cfg.dt_rank_
    (xz,) = column_parallel(x1, p["in_proj"].to(cdt), kind="mamba")
    xz = fused_product(xz, cfg, "xz")
    xh, z = xz.split(xz.shape[-1] // 2, dim=-1)
    xh, conv_buf = _conv_step(conv_buf.to(cdt), xh, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt))
    xh = F.silu(xh)
    proj = tp_copy(row_parallel(xh, p["x_proj"].to(cdt), kind="mamba"),
                   kind="mamba")
    dtr, Bc, Cc = proj.split([R, N, N], dim=-1)
    dt = F.softplus(dtr @ p["dt_proj"].to(cdt)     # see _m1_forward
                    + p["dt_bias"].float())                  # (B,dI) f32
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[..., None] * A)                         # (B,dI,N)
    xf = xh.float()
    h = a * h + (dt * xf)[..., None] * Bc.float()[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cc.float()) + p["ssm_D"].float() * xf
    y = y.to(cdt) * F.silu(z)
    return row_parallel(y, p["out_proj"].to(cdt), kind="mamba"), \
        (conv_buf, h)


# ===================================================================== Mamba2
#: most elements of each of the SSD's (B, g, c, c, nh) fp32 intra-chunk
#: temporaries (64 MB): :func:`_ssd_scan` runs its chunks in groups of g
SSD_GROUP_ELEMS = 1 << 24


def _ssd_scan(xh, dt, A, Bc, Cc, h0, chunk: int):
    """SSD dual form. xh: (B, S, nh, hp); dt: (B, S, nh) fp32; A: (nh,)
    fp32; Bc, Cc: (B, S, N); h0: (B, nh, hp, N) fp32. Returns y (B, S, nh,
    hp) and the final h, both fp32. A ragged S runs as one chunk (the
    reference's rule).

    Each chunk's arithmetic is the reference's ``chunk_step``, but the
    chunks' own work runs batched over a chunk axis: each chunk's state
    from a zero start over all chunks at once, then only the carry, h = h
    * exp(L_last) + h_chunk, steps through the chunks; the decayed
    intra-chunk products in groups of as many chunks as keep each (B, g,
    c, c, nh) temporary within :data:`SSD_GROUP_ELEMS` (at least one
    chunk), so a long prompt's peak memory does not grow with its chunk
    count. A
    zamba2-1.2b training microbatch (one 2048-token sequence) is one
    group; a serving prefill of 8 such prompts runs 8 groups of 2 chunks.
    A Python loop of the whole step per chunk (as the reference's
    ``lax.scan``) launched ~700 small kernels per layer and pass: a
    zamba2-1.2b training step at 8 x 2048 took 20.5 s on an H100, 74% of
    it with the device idle."""
    Bb, S, nh, hp = xh.shape
    N = Bc.shape[-1]
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S
    nc = S // chunk
    xf = xh.float().reshape(Bb, nc, chunk, nh, hp)
    Bf = Bc.float().reshape(Bb, nc, chunk, N)
    Cf = Cc.float().reshape(Bb, nc, chunk, N)
    dtc = dt.reshape(Bb, nc, chunk, nh)
    L = torch.cumsum(dtc * A, dim=2)                          # (B,nc,c,nh)
    # each chunk's state from a zero start: sum_s exp(L_last - L_s) dt_s x_s
    # B_s^T, then the carry through the chunks
    rdecay = torch.exp(L[:, :, -1:, :] - L)                   # (B,nc,c,nh)
    hc = torch.einsum("bcshp,bcsn->bchpn",
                      xf * (dtc * rdecay)[..., None], Bf)
    last = torch.exp(L[:, :, -1])[..., None, None]            # (B,nc,nh,1,1)
    h, h_in = h0, []
    for c in range(nc):
        h_in.append(h)
        h = h * last[:, c] + hc[:, c]
    h_in = torch.stack(h_in, dim=1)                           # (B,nc,nh,hp,N)
    # intra-chunk: causal "attention" with decay. Above the diagonal seg >=
    # 0 may overflow exp; it is masked to -inf BEFORE the exp (the same 0
    # there), where the reference's where(mask, exp(seg), 0) gives a NaN
    # gradient (0 * inf) once a chunk's |sum dt A| passes ~88
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()[:, :, None]
    g = max(1, SSD_GROUP_ELEMS // (Bb * chunk * chunk * nh))
    ys = []
    for c0 in range(0, nc, g):
        k = slice(c0, c0 + g)
        seg = L[:, k, :, None, :] - L[:, k, None, :, :]       # (B,g,t,s,nh)
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        cb = torch.einsum("bctn,bcsn->bcts", Cf[:, k], Bf[:, k])
        w = cb[..., None] * decay * dtc[:, k, None, :, :]
        # plus the carried state's contribution
        ys.append(torch.einsum("bctsh,bcshp->bcthp", w, xf[:, k])
                  + torch.einsum("bctn,bchpn->bcthp", Cf[:, k], h_in[:, k])
                  * torch.exp(L[:, k])[..., None])
    return torch.cat(ys, dim=1).reshape(Bb, S, nh, hp), h


def _m2_out(p, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig, cdt,
            part=None) -> torch.Tensor:
    """Gated norm and out-projection: rms_norm(y * silu(z)) @ out_proj.
    Under the partitioned step (``part``) y and z are the rank's channels:
    the mean of squares is over the whole ``dI`` (the ranks' sums summed),
    and ``out_proj`` is row-parallel."""
    if part is None:
        y = rms_norm(y.to(cdt) * F.silu(z), p["ssm_norm"], cfg.rms_eps)
        return y @ p["out_proj"].to(cdt)
    g = (y.to(cdt) * F.silu(z)).float()
    var = part.sum_over_tp(g.square().sum(dim=-1, keepdim=True)) \
        / cfg.d_inner
    g = (g * torch.rsqrt(var + cfg.rms_eps) * p["ssm_norm"].float()).to(cdt)
    return row_parallel(g, p["out_proj"].to(cdt), kind="mamba")


def _m2_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                return_state: bool = False):
    """Under the partitioned step a rank runs its ``nh / tp`` heads: its
    ``in_proj`` block (or, in a serve step, its product: :func:`repro_torch.
    distributed.sharding.fused_product`) is ``[z_r | x_r | B | C | dt_r]``
    and its conv's ``[x_r | B | C]`` (:func:`repro_torch.distributed.
    sharding.exchange_fused`), B and C whole on every rank (every head
    reads them; their gradients, each rank's of its heads, are summed by
    the exchange's inverse and by ``x``'s entry into the region)."""
    B, S, _ = x.shape
    part = tp_part("mamba")
    n = part.tp_size if part is not None else 1
    dI, N, nh, hp = (cfg.d_inner // n, cfg.ssm_state, cfg.ssm_heads // n,
                     cfg.ssm_head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    (zxbcdt,) = column_parallel(x, p["in_proj"].to(cdt), kind="mamba")
    zxbcdt = fused_product(zxbcdt, cfg, "zxbcdt")
    z, xbc_in, dt = zxbcdt.split([dI, dI + 2 * N, nh], dim=-1)
    xbc = F.silu(_causal_conv(xbc_in, p["conv_w"].to(cdt),
                              p["conv_b"].to(cdt)))
    xh, Bc, Cc = xbc.split([dI, N, N], dim=-1)
    # softplus: see _m1_forward
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B,S,nh)
    A = -torch.exp(p["A_log"].float())                       # (nh,)
    xhh = xh.reshape(B, S, nh, hp)
    if h0 is None:
        h0 = torch.zeros((B, nh, hp, N), dtype=torch.float32,
                         device=x.device)
    y, hT = _ssd_scan(xhh, dt, A, Bc, Cc, h0, cfg.ssm_chunk)
    y = y + p["ssm_D"].float()[:, None] * xhh.float()
    out = _m2_out(p, y.reshape(B, S, dI), z, cfg, cdt, part)
    if return_state:
        return out, (_conv_tail(xbc_in, cfg.ssm_conv), hT)
    return out


def _m2_step(p, x1: torch.Tensor, cfg: ModelConfig, state):
    """x1: (B, D); state = (conv_buf (B, K-1, dI+2N), h (B, nh, hp, N)).
    In a sharded serve step partitioned as :func:`_m2_forward` is: the
    rank's ``nh / tp`` heads, its conv buffer ``[x_r | B | C]`` (B, K-1,
    dI / tp + 2N)."""
    conv_buf, h = state
    B = x1.shape[0]
    part = tp_part("mamba")
    n = part.tp_size if part is not None else 1
    dI, N, nh, hp = (cfg.d_inner // n, cfg.ssm_state, cfg.ssm_heads // n,
                     cfg.ssm_head_dim)
    cdt = dtype_of(cfg.compute_dtype)
    (zxbcdt,) = column_parallel(x1, p["in_proj"].to(cdt), kind="mamba")
    zxbcdt = fused_product(zxbcdt, cfg, "zxbcdt")
    z, xbc, dt = zxbcdt.split([dI, dI + 2 * N, nh], dim=-1)
    xbc, conv_buf = _conv_step(conv_buf.to(cdt), xbc, p["conv_w"].to(cdt),
                               p["conv_b"].to(cdt))
    xh, Bc, Cc = F.silu(xbc).split([dI, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B,nh)
    a = torch.exp(dt * -torch.exp(p["A_log"].float()))      # (B,nh)
    xhh = xh.reshape(B, nh, hp).float()
    h = a[..., None, None] * h \
        + (dt[..., None] * xhh)[..., None] * Bc.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", h, Cc.float()) \
        + p["ssm_D"].float()[:, None] * xhh
    return _m2_out(p, y.reshape(B, dI), z, cfg, cdt, part), (conv_buf, h)


# ==================================================================== dispatch
def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                  return_state: bool = False, impl: str = "kernel"):
    """Full-sequence Mamba block: x (B, S, D) -> (B, S, D) in the compute
    dtype; with ``return_state`` also ``(conv_tail, h)`` in
    :func:`init_mamba_state`'s layout. ``impl`` picks Mamba1's scan
    (:data:`SCAN_IMPLS`); Mamba2's SSD has one path."""
    _require_ssm(cfg)
    if cfg.ssm_version == 2:
        return _m2_forward(p, x, cfg, h0, return_state)
    return _m1_forward(p, x, cfg, h0, return_state, impl)


def mamba_step(p, x1: torch.Tensor, cfg: ModelConfig, state):
    """One token through a Mamba block: x1 (B, D) -> ((B, D), new state)."""
    _require_ssm(cfg)
    f = _m1_step if cfg.ssm_version == 1 else _m2_step
    return f(p, x1, cfg, state)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeros for decode, ``device`` None meaning CUDA. Mamba1: (conv_buf
    (B, K-1, dI) in ``dtype``, h (B, dI, N) fp32); Mamba2: (conv_buf (B,
    K-1, dI+2N) in ``dtype``, h (B, nh, hp, N) fp32)."""
    _require_ssm(cfg)
    dev = resolve_device(device)
    if cfg.ssm_version == 1:
        conv_dim, hshape = cfg.d_inner, (cfg.d_inner, cfg.ssm_state)
    else:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        hshape = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return (torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                        device=dev),
            torch.zeros((batch, *hshape), dtype=torch.float32, device=dev))

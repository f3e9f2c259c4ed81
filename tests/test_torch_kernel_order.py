"""The order of arithmetic of the port's K1 kernel, rendered in plain
PyTorch, against the JAX reference kernel.

The CUDA kernel runs only on the card; its plain version in
``repro_torch.kernels.ref`` keeps the reference's order. This rendering
repeats what ``csrc/paged_attention.cu`` does differently, step for step,
so that the CPU suite holds its algorithm against the TPU kernel: a row's
pages cut into tiles of 4 warp-wide loads that never cross a page, tile i
to warp i % 8; inside a warp every lane group that shares a key position
keeps its own online softmax (m, l, acc); each warp folds its groups, then
the 8 warps are merged once, with ``l == 0 -> 1``. Compared with
``repro.kernels.paged_attention(impl="pallas", interpret=True)`` on ragged
lengths, sink rows and rows of several rounds of tiles, for the bf16 and
fp32 lane layouts, in fp32 at 2e-5 absolute (summation order only).
"""
import math

import jax.numpy as jnp
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as j_paged
from test_torch_kernels import _paged_case
from test_torch_parity import assert_close

NEG_INF = -2.0 ** 30


def k1_order(q, pool, tables, lengths, elem_bytes, warps=8, loads=4):
    """K1's order on (B, H, hd) q and a (2, N, KV, bs, hd) pool: the lane
    layout of elements of ``elem_bytes`` (2: bf16, 4: fp32) read 16 bytes a
    lane."""
    B, H, hd = q.shape
    KV, bs = pool.shape[2], pool.shape[3]
    G, mb = H // KV, tables.shape[1]
    lpk = hd * elem_bytes // 16          # lanes per key row
    kpw = 32 // lpk                      # keys per warp-wide load
    tk = loads * kpw                     # keys per tile
    tpp = math.ceil(bs / tk)             # tiles per page (none crosses one)
    out = torch.empty_like(q)
    for b in range(B):
        n = min(int(lengths[b]) + 1, mb * bs)
        t = torch.arange(n)
        blk = tables[b, t // bs].long()
        k, v = pool[0, blk, :, t % bs], pool[1, blk, :, t % bs]  # (n, KV, hd)
        s = torch.einsum("kgd,nkd->kgn", q[b].reshape(KV, G, hd), k) \
            * hd ** -0.5
        warp_parts = []
        for w in range(warps):
            groups = []
            for kl in range(kpw):
                m = torch.full((KV, G), NEG_INF)
                l = torch.zeros((KV, G))
                acc = torch.zeros((KV, G, hd))
                for tile in range(w, math.ceil(n / bs) * tpp, warps):
                    j, part = divmod(tile, tpp)
                    lim = min(bs, n - j * bs)
                    idx = [j * bs + o for o in range(part * tk + kl,
                                                     (part + 1) * tk, kpw)
                           if o < lim]
                    if not idx:          # masked keys change nothing
                        continue
                    mx = torch.maximum(m, s[..., idx].amax(-1))
                    alpha = torch.exp(m - mx)
                    p = torch.exp(s[..., idx] - mx[..., None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] \
                        + torch.einsum("kgn,nkd->kgd", p, v[idx])
                    m = mx
                groups.append((m, l, acc))
            warp_parts.append(_merge(groups))
        m, l, acc = _merge(warp_parts)
        l = torch.where(l == 0, torch.ones_like(l), l)
        out[b] = (acc / l[..., None]).reshape(H, hd)
    return out


def _merge(parts):
    """Fold partial softmaxes (m, l, acc) into one, as the kernel's warp
    fold and block merge do."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    l = sum(torch.exp(m - mx) * pl for m, pl, _ in parts)
    acc = sum(torch.exp(m - mx)[..., None] * pa for m, _, pa in parts)
    return mx, l, acc


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("H,KV,hd,bs", [(4, 4, 64, 16), (4, 2, 32, 8),
                                        (8, 1, 16, 16), (2, 2, 128, 5)])
def test_k1_order_matches_pallas(elem_bytes, H, KV, hd, bs):
    """Ragged lengths (bs not dividing pos + 1), a sink row, and a row of
    more tiles than the 8 warps take in one round."""
    mb = 320 // bs
    lengths = [0, 7, bs - 1, -1, mb * bs - 1]
    q, pool, tables, ln = _paged_case(5, H, KV, hd, bs, mb, lengths,
                                      seed=hd + bs)
    ref = j_paged(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(tables),
                  jnp.asarray(ln), impl="pallas", interpret=True)
    out = k1_order(*(torch.from_numpy(a) for a in (q, pool, tables, ln)),
                   elem_bytes)
    assert_close(out, ref, 2e-5, "K1 order vs pallas")


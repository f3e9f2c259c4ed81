"""K1/K2/K4 CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernels are CUDA C++ for sm_90a and
have no interpret mode): they carry the ``gpu`` marker and skip elsewhere.
Run them on the card with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Inputs come from numpy with a fixed seed. Tolerances: fp32 cases 2e-5 /
1e-4 absolute (only the summation order differs from the plain version);
bf16 cases 2e-2 absolute (outputs are rounded to bf16, ~4e-3 relative, and
the plain flash version rounds its probabilities to bf16 before p @ v
where the kernel keeps them fp32). K4 (LSDNN layer): fp32 1e-4 x cap
absolute (the same exact fp32 products summed in another order; the plain
version's product runs with TF32 off, PyTorch's default), bf16 0.3 as the
reference's own test (a one-ulp rounding difference of an output near the
cap is 0.125).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import lsdnn_layer as lsdnn_mod
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels.ref import (flash_attention_ref, lsdnn_layer_ref,
                                     paged_attention_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _paged_case(B, H, KV, hd, bs, mb, lengths, dtype, dev, seed=0):
    """Random pool + disjoint block tables covering ``lengths``; a negative
    length parks the row on the sink block (table of zeros, pos 0)."""
    rng = np.random.default_rng(seed)
    N = B * mb + 1
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    pool = rng.standard_normal((2, N, KV, bs, hd)).astype(np.float32)
    tables = np.zeros((B, mb), np.int32)
    free = list(rng.permutation(np.arange(1, N)))
    for b in range(B):
        if lengths[b] < 0:
            continue
        for j in range(lengths[b] // bs + 1):
            tables[b, j] = free.pop()
    ln = np.maximum(np.asarray(lengths, np.int32), 0)
    t = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731
    return t(q).to(dtype), t(pool).to(dtype), t(tables), t(ln)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("H,KV,hd", [(4, 4, 32), (4, 2, 16), (8, 1, 64),
                                     (32, 32, 64), (32, 8, 64), (8, 2, 128)])
def test_paged_kernel_matches_plain(cuda, dtype, tol, H, KV, hd):
    bs, mb = 16, 6
    lengths = [0, 7, bs - 1, 2 * bs, mb * bs - 1, -1]
    q, pool, tables, ln = _paged_case(6, H, KV, hd, bs, mb, lengths, dtype,
                                      cuda)
    n0 = paged_mod.launches
    out = paged_mod.paged_attention(q, pool, tables, ln)
    ref = paged_attention_ref(q, pool, tables, ln)
    torch.cuda.synchronize()
    assert paged_mod.launches == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() < tol


@pytest.mark.parametrize("bs,pos", [(4, 4), (4, 10), (3, 7), (5, 5)])
def test_paged_kernel_block_size_not_dividing_pos(cuda, bs, pos):
    q, pool, tables, ln = _paged_case(2, 4, 2, 16, bs, 4, [pos, pos % bs],
                                      torch.float32, cuda)
    out = paged_mod.paged_attention(q, pool, tables, ln)
    ref = paged_attention_ref(q, pool, tables, ln)
    assert (out - ref).abs().max().item() < 2e-5


def _flash_case(B, S, T, H, KV, hd, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(                  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev).to(dtype)
    return mk(B, S, H, hd), mk(B, T, KV, hd), mk(B, T, KV, hd)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 128, 4, 2, 32),
                                         (1, 100, 8, 8, 64),
                                         (2, 1, 4, 4, 16),
                                         (2, 7, 4, 1, 128),
                                         (4, 128, 32, 32, 64)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, causal, B, S, H, KV,
                                    hd):
    q, k, v = _flash_case(B, S, S, H, KV, hd, dtype, cuda)
    n0 = flash_mod.launches
    out = flash_mod.flash_attention(q, k, v, causal=causal)
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() < tol


def test_flash_kernel_ragged_kv_non_causal(cuda):
    """S != T and T not a tile multiple (non-causal cross attention)."""
    q, k, v = _flash_case(2, 40, 77, 4, 2, 64, torch.float32, cuda)
    out = flash_mod.flash_attention(q, k, v, causal=False)
    ref = flash_attention_ref(q, k, v, causal=False)
    assert (out - ref).abs().max().item() < 1e-4


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, pool, tables, ln = _paged_case(2, 4, 2, 16, 4, 4, [3, 5],
                                      torch.float32, cuda)
    with pytest.raises(TypeError):
        paged_mod.paged_attention(q.half(), pool.half(), tables, ln)
    with pytest.raises(TypeError):
        paged_mod.paged_attention(q, pool, tables.long(), ln)
    with pytest.raises(ValueError):
        paged_mod.paged_attention(q, pool, tables[:, ::2], ln)
    qf, kf, vf = _flash_case(1, 8, 8, 4, 2, 48, torch.float32, cuda)
    with pytest.raises(ValueError):                    # head dim 48
        flash_mod.flash_attention(qf, kf, vf)


def _lsdnn_case(T, F, G, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(                  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    return mk(T, F).to(dtype), (mk(F, G) * 0.05).to(dtype), mk(G).to(dtype)


def _check_lsdnn(y, w, b, cap=32.0):
    tol = 1e-4 * cap if y.dtype == torch.float32 else 0.3
    n0 = lsdnn_mod.launches
    out = lsdnn_mod.lsdnn_layer(y, w, b, cap=cap)
    ref = lsdnn_layer_ref(y, w, b, cap=cap)
    torch.cuda.synchronize()
    assert lsdnn_mod.launches == n0 + 1
    assert out.dtype == y.dtype and out.shape == (y.shape[0], w.shape[1])
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() < tol
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,F,G", [(128, 256, 128), (256, 128, 64),
                                   (64, 64, 64), (1000, 1024, 1000),
                                   (1, 3, 5), (300, 130, 257),
                                   (4096, 1024, 1024)])
def test_lsdnn_kernel_matches_plain(cuda, dtype, T, F, G):
    """Tile multiples, ragged T and G (vector loads), and F or G not a
    multiple of 4 (the scalar-load variant)."""
    _check_lsdnn(*_lsdnn_case(T, F, G, dtype, cuda))


def test_lsdnn_kernel_clamps_at_cap(cuda):
    y = torch.full((64, 64), 10.0, device=cuda)
    w = torch.ones((64, 64), device=cuda)
    b = torch.zeros(64, device=cuda)
    out = _check_lsdnn(y, w, b, cap=32.0)
    assert out.max().item() == 32.0 and out.min().item() >= 0.0


def test_lsdnn_kernel_misaligned_rows(cuda):
    """A view starting one element into its storage: the kernel takes the
    scalar-load variant."""
    y, w, b = _lsdnn_case(65, 64, 64, torch.float32, cuda)
    ys = torch.empty(65 * 64 + 1, device=cuda)[1:].view(65, 64)
    ys.copy_(y)
    assert ys.data_ptr() % 16 != 0 and ys.is_contiguous()
    _check_lsdnn(ys, w, b)


def test_lsdnn_kernel_hpec_layer(cuda):
    """One layer of the HPEC network (32 weights of 1/16 per neuron, bias
    -0.3) on binary rows: sums of sixteenths are exact, so the kernel
    equals the plain version bit for bit."""
    from repro_torch.bench.fig13_lsdnn import make_hpec
    net = make_hpec(layers=1, neurons=1024, rows=3000, seed=0)
    y, w, b = (torch.from_numpy(a).to(cuda) for a in
               (net.y0, net.ws[0], net.b))
    out = lsdnn_mod.lsdnn_layer(y, w, b)
    assert torch.equal(out, lsdnn_layer_ref(y, w, b))


def test_lsdnn_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    y, w, b = _lsdnn_case(8, 8, 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        lsdnn_mod.lsdnn_layer(y.half(), w.half(), b.half())
    with pytest.raises(TypeError):
        lsdnn_mod.lsdnn_layer(y, w.bfloat16(), b)
    with pytest.raises(ValueError):
        lsdnn_mod.lsdnn_layer(y, w.t(), b)              # not contiguous
    with pytest.raises(ValueError):
        lsdnn_mod.lsdnn_layer(y, w[:4], b)              # F mismatch
    with pytest.raises(ValueError):
        lsdnn_mod.lsdnn_layer(y, w, b.cpu())

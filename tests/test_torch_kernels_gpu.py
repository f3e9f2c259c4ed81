"""K1/K2/K4 CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernels are CUDA C++ for sm_90a and
have no interpret mode): they carry the ``gpu`` marker and skip elsewhere.
Run them on the card with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

K1 also on rows longer than its 8 warps' first round of pages, past its
shared copy of the block table, on misaligned views and inside a CUDA
graph. Inputs come from numpy with a fixed seed. Tolerances: fp32 cases 2e-5 /
1e-4 absolute (only the summation order differs from the plain version);
bf16 cases 2e-2 absolute (outputs are rounded to bf16, ~4e-3 relative; K2
and the plain flash version both round their probabilities to bf16 before
p @ v, K2 before normalising and the plain version after, and K2 takes
exp2 on the tensor cores' fp32 scores). K4 (LSDNN layer): fp32 1e-4 x cap
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_paged_kernel_long_rows(cuda, dtype, tol, bs, hd, G):
    """Rows longer than the 8 warps' first round of tiles (2,048 keys: 8 to
    128 tiles a row), beside a short row and a sink row; G query heads per
    kv head (G = 8 takes two blocks of 4 heads each)."""
    mb = 2048 // bs
    lengths = [2047, 1000, -1, 5]
    q, pool, tables, ln = _paged_case(4, 2 * G, 2, hd, bs, mb, lengths,
                                      dtype, cuda, seed=bs + hd + G)
    out = paged_mod.paged_attention(q, pool, tables, ln)
    ref = paged_attention_ref(q, pool, tables, ln)
    torch.cuda.synchronize()
    assert out.dtype == dtype and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() < tol


def test_paged_kernel_table_past_its_shared_copy(cuda):
    """1,251 pages in a row (bs = 2): the kernel stages the first 1,024
    block-table entries in shared memory and reads the rest from global
    memory."""
    q, pool, tables, ln = _paged_case(2, 4, 2, 16, 2, 1300, [2501, 40],
                                      torch.float32, cuda)
    out = paged_mod.paged_attention(q, pool, tables, ln)
    ref = paged_attention_ref(q, pool, tables, ln)
    assert (out - ref).abs().max().item() < 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_misaligned_inputs(cuda, dtype):
    """q and pool views one element into their storage: the kernel reads
    them element by element instead of 16 bytes at a time, with the same
    arithmetic."""
    q, pool, tables, ln = _paged_case(3, 8, 2, 64, 16, 8, [100, 0, 37],
                                      dtype, cuda)
    qs = torch.empty(q.numel() + 1, device=cuda, dtype=dtype)[1:] \
        .view(q.shape)
    ps = torch.empty(pool.numel() + 1, device=cuda, dtype=dtype)[1:] \
        .view(pool.shape)
    qs.copy_(q)
    ps.copy_(pool)
    assert qs.data_ptr() % 16 and ps.data_ptr() % 16
    out = paged_mod.paged_attention(qs, ps, tables, ln)
    assert torch.equal(out, paged_mod.paged_attention(q, pool, tables, ln))


def test_paged_kernel_in_a_cuda_graph(cuda):
    """K1 captured into a CUDA graph and replayed equals the eager launch
    bit for bit; the graph reads lengths and tables from device memory, so
    a replay after they change (a decode step later) sees the new rows."""
    q, pool, tables, ln = _paged_case(4, 8, 8, 64, 16, 8, [0, 17, 64, 120],
                                      torch.bfloat16, cuda)
    eager = paged_mod.paged_attention(q, pool, tables, ln)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_mod.paged_attention(q, pool, tables, ln)   # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = paged_mod.launches
    with torch.cuda.graph(graph):
        out = paged_mod.paged_attention(q, pool, tables, ln)
    assert paged_mod.launches == n0 + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    ln.add_(3)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, paged_mod.paged_attention(q, pool, tables, ln))
    assert not torch.equal(out, eager)


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


def _check_flash(q, k, v, causal):
    n0 = flash_mod.launches
    out = flash_mod.flash_attention(q, k, v, causal=causal)
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.launches == n0 + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 15, 100, 130])
def test_flash_bf16_ragged_query_tile(cuda, S, causal):
    """S not a multiple of the 64-row q tile: rows past S are computed on
    zeros and never stored; a warp wholly past S only loads."""
    _check_flash(*_flash_case(2, S, S, 8, 4, 64, torch.bfloat16, cuda),
                 causal)


@pytest.mark.parametrize("S,T", [(40, 77), (128, 65), (1, 200), (100, 31)])
def test_flash_bf16_cross_attention_non_causal(cuda, S, T):
    """T != S, T ragged against the 64-key tile (one real key in the last
    tile at T = 65), non-causal."""
    _check_flash(*_flash_case(2, S, T, 4, 2, 64, torch.bfloat16, cuda),
                 False)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_bf16_head_dims_gqa4(cuda, hd):
    """Every head dim, GQA with 4 query heads per kv head, causal over two
    and a half kv tiles."""
    _check_flash(*_flash_case(2, 150, 150, 8, 2, hd, torch.bfloat16, cuda),
                 True)


def test_flash_bf16_rows_that_see_one_key(cuda):
    """The most-masked rows this API can make: causal row 0 sees key 0
    only, the other 63 keys of its tile masked; at S = T = 65 row 64's last
    tile holds one key it sees and 63 past T. No row has every key masked
    (the causal mask keeps key 0 for all rows). Row 0 of a one-key softmax
    is exactly that key's value row."""
    q, k, v = _flash_case(1, 65, 65, 4, 4, 64, torch.bfloat16, cuda)
    out = _check_flash(q, k, v, True)
    assert torch.equal(out[:, 0], v[:, 0])


def test_flash_bf16_misaligned_inputs(cuda):
    """A q view one element into its storage: the kernel loads its tiles
    with plain loads instead of 16-byte copies."""
    q, k, v = _flash_case(2, 33, 33, 4, 2, 64, torch.bfloat16, cuda)
    qs = torch.empty(q.numel() + 1, device=cuda, dtype=q.dtype)[1:] \
        .view(q.shape)
    qs.copy_(q)
    assert qs.data_ptr() % 16 != 0 and qs.is_contiguous()
    out = _check_flash(qs, k, v, True)
    assert torch.equal(out, flash_mod.flash_attention(q, k, v))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,F,G", [(1000, 1000, 1000), (999, 130, 257),
                                   (5, 130, 257), (31, 33, 7)])
def test_lsdnn_kernel_ragged_tiles_and_k_steps(cuda, dtype, T, F, G):
    """T, F and G off the 128 x 128 tile and the 32-deep K step; G = 257
    and 7 take the 4-byte copies of w; T = 5 and 31 are smaller than one
    tile (every block gets a strip of it)."""
    _check_lsdnn(*_lsdnn_case(T, F, G, dtype, cuda))


@pytest.mark.parametrize("T", [4430, 5800, 60000])
def test_lsdnn_kernel_persistent_rounds_and_tail(cuda, T):
    """F = G = 1024 with more tiles than the persistent grid: on an H100
    (132 SMs x 2 blocks) T = 4430 leaves 16 tiles after one full round
    (cut into 4 strips each), T = 5800 104 (2 strips), T = 60000 the HPEC
    shape, 14 rounds and 56 tiles in strips of 32 rows."""
    _check_lsdnn(*_lsdnn_case(T, 1024, 1024, torch.float32, cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lsdnn_kernel_misaligned_y_and_w(cuda, dtype):
    """y and w views one element into their storage: y's elementwise
    copies take any alignment, w falls back to 4-byte copies."""
    y, w, b = _lsdnn_case(300, 128, 256, dtype, cuda)
    ys = torch.empty(y.numel() + 1, device=cuda, dtype=dtype)[1:] \
        .view(y.shape)
    ws = torch.empty(w.numel() + 1, device=cuda, dtype=dtype)[1:] \
        .view(w.shape)
    ys.copy_(y)
    ws.copy_(w)
    out = _check_lsdnn(ys, ws, b)
    assert torch.equal(out, lsdnn_mod.lsdnn_layer(y, w, b))


def test_lsdnn_kernel_in_a_deviceflow_capture(cuda):
    """K4 recorded into a DeviceFlow's CUDA graph (the kernel's 99,840 B of
    dynamic shared memory was opted in when the library was loaded, not in
    the launch the capture records): the replay equals the eager launch bit
    for bit."""
    from repro_torch.core import DeviceFlow
    y, w, b = _lsdnn_case(700, 256, 300, torch.float32, cuda)
    eager = lsdnn_mod.lsdnn_layer(y, w, b, cap=4.0).cpu().numpy()
    df = DeviceFlow(cuda)
    df.copy("y", y.cpu().numpy())
    df.kernel(lambda x: lsdnn_mod.lsdnn_layer(x, w, b, cap=4.0), ["y"],
              ["out"])
    df.fetch("out")
    first = df.offload()["out"]
    again = df.offload(2)["out"]
    assert df.captured_launches == {"lsdnn_layer": 1}
    assert df.num_launches == 3
    np.testing.assert_array_equal(first, eager)
    np.testing.assert_array_equal(again, eager)


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

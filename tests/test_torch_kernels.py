"""The kernels' plain PyTorch versions against the JAX reference kernels.

* ``paged_attention_ref`` (the page loop K1 falls back to on the CPU) vs
  ``repro.kernels.paged_attention.paged_attention(impl="pallas",
  interpret=True)`` and vs the gather oracle, over the cases of
  ``tests/test_paged_attention.py``: GQA ratios, ragged lengths, sink rows,
  block sizes that do not divide ``pos + 1``.
* the plain flash attention vs ``repro.kernels.flash_attention`` in
  interpret mode, causal and not, and vs ``flash_attention_ref`` at a
  ragged S (which the TPU kernel does not take).
* the dispatch: CPU tensors take the plain versions and launch nothing;
  the CUDA entry points refuse CPU tensors (no fallback either way).

The kernel-vs-plain cases on the card are in
``tests/test_torch_kernels_gpu.py`` (``gpu`` marker). Tolerance: fp32
throughout, 2e-5 absolute (summation order only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.paged_attention import paged_attention as j_paged
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.serve.kvcache import gather_read_attention as j_gather
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as paged_mod
from repro_torch.kernels.ref import flash_attention_ref, paged_attention_ref
from repro_torch.models.attention import _chunked_attention, _full_attention
from repro_torch.serve.kvcache import gather_read_attention
from test_torch_parity import assert_close

TOL = 2e-5


def _paged_case(B, H, KV, hd, bs, mb, lengths, seed=0):
    """numpy pool + disjoint block tables covering ``lengths``; a negative
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
    return q, pool, tables, np.maximum(np.asarray(lengths, np.int32), 0)


def _check_paged(q, pool, tables, ln):
    ref_pallas = j_paged(jnp.asarray(q), jnp.asarray(pool),
                         jnp.asarray(tables), jnp.asarray(ln),
                         impl="pallas", interpret=True)
    ref_gather = j_gather(jnp.asarray(q), jnp.asarray(pool),
                          jnp.asarray(tables), jnp.asarray(ln))
    t = [torch.from_numpy(a) for a in (q, pool, tables, ln)]
    out = paged_attention_ref(*t)
    assert_close(out, ref_pallas, TOL, "loop vs pallas")
    assert_close(out, ref_gather, TOL, "loop vs jax gather")
    assert_close(gather_read_attention(*t), ref_gather, TOL,
                 "torch gather vs jax gather")
    return out


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
def test_paged_loop_matches_pallas_and_gather_across_gqa(H, KV):
    bs, mb = 16, 6
    lengths = [0, 7, bs - 1, 2 * bs, mb * bs - 1]
    _check_paged(*_paged_case(5, H, KV, 32, bs, mb, lengths))


def test_paged_loop_sink_rows():
    lengths = [5, -1, 20, -1]
    q, pool, tables, ln = _paged_case(4, 4, 2, 16, 8, 4, lengths)
    assert tables[1].sum() == 0 and tables[3].sum() == 0
    out = _check_paged(q, pool, tables, ln)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("bs,pos", [(4, 4), (4, 10), (3, 7), (5, 5)])
def test_paged_loop_block_size_not_dividing_pos(bs, pos):
    _check_paged(*_paged_case(2, 4, 2, 16, bs, 4, [pos, pos % bs]))


def test_paged_loop_double_count_guard():
    """A short row beside a long one: once the short row's pages run out,
    the loop keeps re-reading its last page (the per-row clamp) and only
    the ``j < nb_row`` guard stops it from counting that page twice."""
    q, pool, tables, ln = _paged_case(2, 4, 4, 16, 4, 8, [1, 29])
    out = _check_paged(q, pool, tables, ln)
    alone = paged_attention_ref(torch.from_numpy(q[:1]),
                                torch.from_numpy(pool),
                                torch.from_numpy(tables[:1]),
                                torch.from_numpy(ln[:1]))
    assert_close(out[:1], alone, TOL, "short row unaffected by long row")


def _qkv(B, S, T, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,H,KV", [(128, 4, 2), (64, 4, 4), (64, 8, 1)])
def test_plain_flash_matches_pallas_flash(causal, S, H, KV):
    q, k, v = _qkv(2, S, S, H, KV, 32)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, block_q=32, block_k=32, interpret=True)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    assert_close(out, ref, TOL, "plain flash vs pallas flash")


@pytest.mark.parametrize("S", [1, 7, 100])
def test_plain_flash_ragged_matches_reference_and_chunked(S):
    """Ragged S (the engine's windows are any power of two <= the prefill
    chunk; the chunked path pads): the plain flash version equals the JAX
    ref and the port's full and chunked attention paths."""
    q, k, v = _qkv(2, S, S, 4, 2, 16, seed=S)
    ref = j_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention_ref(tq, tk, tv)
    assert_close(out, ref, TOL, "flash ref")
    pos = torch.arange(S).expand(2, S)
    assert_close(_full_attention(tq, tk, tv, pos, pos), ref, TOL, "full")
    assert_close(_chunked_attention(tq, tk, tv, pos, pos, 16), ref, TOL,
                 "chunked")


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    q, pool, tables, ln = (torch.from_numpy(a) for a in
                           _paged_case(2, 4, 2, 16, 4, 4, [3, 9]))
    n_paged, n_flash = paged_mod.launches, flash_mod.launches
    a = ops.paged_attention(q, pool, tables, ln, impl="kernel")
    b = ops.paged_attention(q, pool, tables, ln, impl="loop")
    assert torch.equal(a, b)
    fq, fk, fv = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 4, 2, 16))
    assert torch.equal(ops.flash_attention(fq, fk, fv),
                       flash_attention_ref(fq, fk, fv))
    assert (paged_mod.launches, flash_mod.launches) == (n_paged, n_flash)
    with pytest.raises(ValueError):
        ops.paged_attention(q, pool, tables, ln, impl="pallas")


def test_cuda_entry_points_refuse_cpu_tensors():
    q, pool, tables, ln = (torch.from_numpy(a) for a in
                           _paged_case(2, 4, 2, 16, 4, 4, [3, 9]))
    with pytest.raises(ValueError, match="CUDA"):
        paged_mod.paged_attention_cuda(q, pool, tables, ln)
    fq, fk, fv = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention_cuda(fq, fk, fv)


def test_default_paged_impl(monkeypatch):
    monkeypatch.delenv("REPRO_PAGED_IMPL", raising=False)
    assert ops.default_paged_impl(torch.device("cpu")) == "loop"
    assert ops.default_paged_impl(torch.device("cuda", 0)) == "kernel"
    assert ops.default_paged_impl() == "loop"
    monkeypatch.setenv("REPRO_PAGED_IMPL", "gather")
    assert ops.default_paged_impl(torch.device("cuda", 0)) == "gather"
    monkeypatch.setenv("REPRO_PAGED_IMPL", "pallas")
    with pytest.raises(ValueError):
        ops.default_paged_impl()


def test_launch_counts_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"paged_attention": 0,
                                   "flash_attention": 0,
                                   "mamba_scan": 0,
                                   "mamba_scan_bwd": 0,
                                   "lsdnn_layer": 0}

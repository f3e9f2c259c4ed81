"""The port's paged KV pool against ``repro.serve.kvcache``.

Each device-side scatter writes, IN PLACE, the same bytes the reference's
functional ``.at[].set`` produces: pools are compared through an integer
view (bf16 as uint16, fp32 as uint32) with the sink block 0 masked out —
masked and inactive entries all land there with duplicate indices, and
which duplicate wins is unspecified (on CUDA ``index_put_`` picks any).
Gathers are exact; the gather oracle is compared at 2e-5 (fp32) / 2e-2
(bf16). ``copy_blocks``, the prefix cache's fork, is compared the same
way. The host ``BlockPool`` copy hands out the same ids as the
reference's on one alloc/grow/free/deferred call sequence.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import kvcache as jkv
from repro_torch.serve import kvcache as tkv
from test_torch_parity import TOL, assert_close, smoke_cfg, to_torch

DTYPES = [("float32", jnp.float32), ("bfloat16", jnp.bfloat16)]


def _bits(x) -> np.ndarray:
    """Integer view of a pool (torch or JAX), sink block (axis -4) zeroed."""
    if isinstance(x, torch.Tensor):
        a = x.contiguous().view(torch.int16 if x.dtype == torch.bfloat16
                                else torch.int32).numpy().copy()
    else:
        a = np.asarray(x)
        a = a.view(np.int16 if a.dtype.name == "bfloat16" else np.int32) \
            .copy()
    a[..., 0, :, :, :] = 0
    return a


def _pool(shape, jdt, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(jdt)
    return j, to_torch(np.asarray(j))


def _same_bytes(tpool, jpool):
    assert np.array_equal(_bits(tpool), _bits(jpool))


@pytest.mark.parametrize("name,jdt", DTYPES)
def test_scatter_prefill_rows_and_row(name, jdt):
    L, N, KV, bs, hd = 2, 12, 2, 4, 8
    jp, tp = _pool((L, 2, N, KV, bs, hd), jdt)
    rng = np.random.default_rng(1)
    blocks = np.array([[3, 7, 1], [5, 0, 0], [0, 0, 0]], np.int32)  # pad rows
    kr = rng.standard_normal((L, 3, KV, 10, hd)).astype(np.float32)
    vr = rng.standard_normal((L, 3, KV, 10, hd)).astype(np.float32)
    jp = jkv.scatter_prefill_rows(jp, jnp.asarray(blocks),
                                  jnp.asarray(kr, jdt), jnp.asarray(vr, jdt))
    out = tkv.scatter_prefill_rows(tp, torch.from_numpy(blocks),
                                   to_torch(np.asarray(jnp.asarray(kr, jdt))),
                                   to_torch(np.asarray(jnp.asarray(vr, jdt))))
    assert out is tp                       # in place, same tensor returned
    _same_bytes(tp, jp)
    one = np.array([9, 10], np.int32)
    jp = jkv.scatter_prefill_row(jp, jnp.asarray(one),
                                 jnp.asarray(kr[:, 0, :, :6], jdt),
                                 jnp.asarray(vr[:, 0, :, :6], jdt))
    tkv.scatter_prefill_row(
        tp, torch.from_numpy(one),
        to_torch(np.asarray(jnp.asarray(kr[:, 0, :, :6], jdt))),
        to_torch(np.asarray(jnp.asarray(vr[:, 0, :, :6], jdt))))
    _same_bytes(tp, jp)


@pytest.mark.parametrize("name,jdt", DTYPES)
def test_scatter_token_window(name, jdt):
    N, KV, bs, hd, C = 12, 2, 4, 8, 6
    jp, tp = _pool((2, N, KV, bs, hd), jdt, seed=2)
    rng = np.random.default_rng(3)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    start = np.array([2, 9, 0], np.int32)        # crosses block boundaries
    valid = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 1],
                      [0, 0, 0, 0, 0, 0]], bool)
    k = rng.standard_normal((3, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((3, C, KV, hd)).astype(np.float32)
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    jp = jkv.scatter_token_window(jp, jk, jv, jnp.asarray(tables),
                                  jnp.asarray(start), jnp.asarray(valid))
    tkv.scatter_token_window(tp, to_torch(np.asarray(jk)),
                             to_torch(np.asarray(jv)),
                             torch.from_numpy(tables),
                             torch.from_numpy(start),
                             torch.from_numpy(valid))
    _same_bytes(tp[None], jp[None])


@pytest.mark.parametrize("name,jdt", DTYPES)
def test_append_kv_and_gathers(name, jdt):
    N, KV, bs, hd = 12, 2, 4, 8
    jp, tp = _pool((2, N, KV, bs, hd), jdt, seed=4)
    rng = np.random.default_rng(5)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9], [0, 0, 0]], np.int32)
    pos = np.array([0, 5, 11, 3], np.int32)
    active = np.array([True, True, True, False])
    k = rng.standard_normal((4, KV, hd)).astype(np.float32)
    v = rng.standard_normal((4, KV, hd)).astype(np.float32)
    jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
    jp = jkv.append_kv(jp, jk, jv, jnp.asarray(tables), jnp.asarray(pos),
                       jnp.asarray(active))
    tkv.append_kv(tp, to_torch(np.asarray(jk)), to_torch(np.asarray(jv)),
                  torch.from_numpy(tables), torch.from_numpy(pos),
                  torch.from_numpy(active))
    _same_bytes(tp[None], jp[None])
    jks, jvs = jkv.gather_pages(jp, jnp.asarray(tables))
    tks, tvs = tkv.gather_pages(tp, torch.from_numpy(tables))
    rows = slice(0, 3)                       # row 3 reads the sink block
    assert np.array_equal(_np(tks)[rows], _np(jks)[rows])
    assert np.array_equal(_np(tvs)[rows], _np(jvs)[rows])
    q = rng.standard_normal((4, 4, hd)).astype(np.float32)
    jq = jnp.asarray(q, jdt)
    ref = jkv.gather_read_attention(jq, jp, jnp.asarray(tables),
                                    jnp.asarray(pos))
    out = tkv.gather_read_attention(to_torch(np.asarray(jq)), tp,
                                    torch.from_numpy(tables),
                                    torch.from_numpy(pos))
    assert out.dtype == tp.dtype
    assert_close(out[rows], ref[rows], TOL[name], "gather_read_attention")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def test_table_updates_in_place():
    tables = np.zeros((4, 6), np.int32)
    jt = jkv.extend_block_tables(jnp.asarray(tables),
                                 jnp.asarray([1, 1, 3], jnp.int32),
                                 jnp.asarray([0, 1, 5], jnp.int32),
                                 jnp.asarray([7, 8, 9], jnp.int32))
    tt = torch.from_numpy(tables.copy())
    out = tkv.extend_block_tables(tt, torch.tensor([1, 1, 3]),
                                  torch.tensor([0, 1, 5]),
                                  torch.tensor([7, 8, 9]))
    assert out is tt and np.array_equal(tt.numpy(), np.asarray(jt))
    new = np.arange(12, dtype=np.int32).reshape(2, 6)
    jt = jkv.set_table_rows(jt, jnp.asarray([0, 3], jnp.int32),
                            jnp.asarray(new))
    tkv.set_table_rows(tt, torch.tensor([0, 3]), torch.from_numpy(new))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert tt.dtype == torch.int32


@pytest.mark.parametrize("rows,pad", [([2, 5, 0], 0), ([4], 3),
                                      ([1, 6, 6, 3], 2)])
def test_set_carry_rows(rows, pad):
    """The async carry's row writes, in place into views of one (3, B)
    buffer, against the reference's on the same rows; padded rows repeat
    the last entry (and a row may repeat with equal values): idempotent."""
    B = 8
    rng = np.random.default_rng(len(rows) + pad)
    base = rng.integers(0, 50, size=(3, B)).astype(np.int32)
    vals = rng.integers(0, 50, size=(3, len(rows))).astype(np.int32)
    for i, r in enumerate(rows):       # a repeated row takes equal values
        vals[:, i] = vals[:, rows.index(r)]
    idx = np.asarray(rows + [rows[-1]] * pad, np.int32)
    vals = np.concatenate([vals, np.repeat(vals[:, -1:], pad, axis=1)], 1)
    ref = jkv.set_carry_rows(*(jnp.asarray(b) for b in base),
                             jnp.asarray(idx), *(jnp.asarray(v)
                                                 for v in vals))
    carry = torch.from_numpy(base.copy())
    out = tkv.set_carry_rows(carry[0], carry[1], carry[2],
                             torch.from_numpy(idx),
                             *(torch.from_numpy(v) for v in vals))
    for o, c, r in zip(out, carry, ref):
        assert o.data_ptr() == c.data_ptr()       # written in place
        assert np.array_equal(c.numpy(), np.asarray(r))
    assert carry.dtype == torch.int32
    untouched = [b for b in range(B) if b not in rows]
    assert np.array_equal(carry.numpy()[:, untouched], base[:, untouched])


@pytest.mark.parametrize("name,jdt", DTYPES)
def test_copy_blocks(name, jdt):
    """The copy-on-write fork: whole blocks across every layer, in place,
    the same bytes as the reference's; block 3 is a source and a
    destination in one call (the gather reads it before the write)."""
    L, N, KV, bs, hd = 3, 12, 2, 4, 8
    jp, tp = _pool((L, 2, N, KV, bs, hd), jdt, seed=7)
    srcs = np.array([3, 5, 9], np.int32)
    dsts = np.array([7, 3, 11], np.int32)
    before = tp.clone()
    jp = jkv.copy_blocks(jp, jnp.asarray(srcs), jnp.asarray(dsts))
    out = tkv.copy_blocks(tp, torch.from_numpy(srcs), torch.from_numpy(dsts))
    assert out is tp
    _same_bytes(tp, jp)
    assert torch.equal(tp[:, :, 3], before[:, :, 5])
    assert torch.equal(tp[:, :, 7], before[:, :, 3])


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_init_kv_pool(name):
    cfg = smoke_cfg("qwen3-14b", name)
    pool = tkv.init_kv_pool(cfg, 9, 4, device="cpu")
    ref = jkv.init_kv_pool(cfg, 9, 4)
    assert tuple(pool.shape) == ref.shape
    assert str(pool.dtype).split(".")[-1] == ref.dtype.name
    assert not pool.any()
    with pytest.raises(ValueError):
        tkv.init_kv_pool(smoke_cfg("falcon-mamba-7b"), 9, 4, device="cpu")


def test_block_pool_same_ids_as_reference():
    """One alloc / grow / incref / free / free_deferred / release / reserve
    / defragment call sequence on both allocators: same ids, same counts."""
    pools = [jkv.BlockPool(16, 4), tkv.BlockPool(16, 4)]
    log = [[], []]
    for i, p in enumerate(pools):
        out = log[i]
        a = p.alloc(3)
        b = p.alloc(4)
        out += [a, b, p.blocks_for(9), p.num_free]
        tab = list(a)
        out.append(p.grow_table(tab, 2))
        out.append(tab)
        p.incref(b[:2])
        p.free(b)
        out += [p.num_free, p.refcount(b[0]), p.num_shared]
        p.free_deferred(tab)
        out += [p.num_free, p.num_deferred, p.alloc(20)]
        out.append(p.release_deferred())
        out.append(p.release_deferred())
        out += [p.num_free, p.num_deferred]
        p.set_reserved(3)
        out += [p.num_free_unreserved, p.can_alloc(p.num_free),
                p.can_alloc(p.num_free, use_reserved=True)]
        c = p.alloc(2, use_reserved=True)
        out += [c, round(p.fragmentation(), 6)]
        p.free(b[:2])
        out.append(round(p.defragment(), 6))
        out += [p.alloc(5), p.num_free, p.num_allocated]
        with pytest.raises(ValueError):
            p.free([0])
    assert log[0] == log[1]

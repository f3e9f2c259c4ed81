"""The port's AdamW and gradient compression against ``repro.optim`` on
seeded trees, and the reference's own optimizer cases
(``tests/test_optim.py``) on the port.

Tolerances: fp32 moments — params, m, v, ``grad_norm`` and ``lr`` within
1e-6 relative to each leaf's largest magnitude (the arithmetic is the
reference's, op for op; only ``pow``, ``sqrt`` and the norm's summation
order may round differently); bf16 moments — m and v within one bf16 ulp
of each element (2**-8 relative: the fp32 values before the store may
straddle a rounding boundary). Compression: the dequantised grads bit
for bit; the error state ``g + e - deq`` within one bf16 ulp plus one fp32
ulp of the gradient's scale (XLA may contract it into one FMA; measured:
at most 1.0e-7 on grads of magnitude ~3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.optim import (OptConfig, adamw_update, compress_grads,
                               init_error_state, init_opt_state, lr_at)
from repro_torch.tree import leaves
from test_torch_parity import to_np

REL = 1e-6
BF16_ULP = 2.0 ** -8


def _tree(seed):
    """A seeded tree of 1-D and 2-D leaves (and one 3-D, decayed too)."""
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.standard_normal((6, 5)).astype(np.float32),
                       "ln": rng.standard_normal((5,)).astype(np.float32)},
            "embed": rng.standard_normal((3, 4, 2)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _rel_close(a, b, rel, what):
    a, b = to_np(a), to_np(b)
    scale = max(float(np.max(np.abs(b))), 1e-30)
    err = float(np.max(np.abs(a - b)))
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 99, 100, 150])
def test_lr_at_matches_reference(step):
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = lr_at(OptConfig(**cfg), step)
    want = jadamw.lr_at(jadamw.OptConfig(**cfg), step)
    assert got.dtype == torch.float32 and got.dim() == 0
    _rel_close(got, want, REL, f"lr_at({step})")


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """Four chained updates from the same params and grads; the third's
    grads are huge, so the clip scale is below 1 there."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, moment_dtype=moments)
    jcfg, tcfg = jadamw.OptConfig(**kw), OptConfig(**kw)
    p0 = _tree(0)
    jp, tp = _j(p0), _t(p0)
    js, ts = jadamw.init_opt_state(jp, jcfg), init_opt_state(tp, tcfg)
    j_upd = jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, jcfg))
    for i in range(4):
        g = _tree(10 + i)
        if i == 2:
            g = jax.tree_util.tree_map(lambda a: a * 1e4, g)
        jp, js, jm = j_upd(jp, _j(g), js)
        tp, ts, tm = adamw_update(tp, _t(g), ts, tcfg)
        _rel_close(tm["grad_norm"], jm["grad_norm"], REL, "grad_norm")
        _rel_close(tm["lr"], jm["lr"], REL, "lr")
        assert int(ts["count"]) == int(js["count"]) == i + 1
        for a, b in zip(leaves(tp), jax.tree_util.tree_leaves(jp)):
            _rel_close(a, b, REL, f"params, update {i}")
        for key in ("m", "v"):
            for a, b in zip(leaves(ts[key]),
                            jax.tree_util.tree_leaves(js[key])):
                assert a.dtype == getattr(torch, moments)
                if moments == "float32":
                    _rel_close(a, b, REL, f"{key}, update {i}")
                else:
                    a, b = to_np(a), to_np(b)
                    assert np.all(np.abs(a - b) <= BF16_ULP * np.abs(b)), \
                        f"{key}, update {i}"


def test_compress_grads_matches_reference():
    g, e = _tree(3), _tree(4)
    err = jax.tree_util.tree_map(
        lambda a: (a * 1e-3).astype(jnp.bfloat16), _j(e))
    terr = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy() * np.float32(1e-3)).bfloat16(), e)
    jg, je = jax.jit(jcompress.compress_grads)(_j(g), err)
    tg, te = compress_grads(_t(g), terr)
    for a, b in zip(leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    for a, b, x in zip(leaves(te), jax.tree_util.tree_leaves(je),
                       leaves(g)):
        assert a.dtype == torch.bfloat16
        a, b = to_np(a), to_np(b)
        fp32_ulp = 2.0 ** -23 * float(np.max(np.abs(x)))
        assert np.all(np.abs(a - b) <= BF16_ULP * np.abs(b) + fp32_ulp)
    assert all(t.dtype == torch.bfloat16
               for t in leaves(init_error_state(_t(g))))


def test_adamw_minimizes_quadratic():
    cfg = OptConfig(lr=0.05, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = init_opt_state(params, cfg)
    target = torch.ones(3)
    for _ in range(200):
        grads = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(torch.sum(torch.square(params["w"] - target))) < 1e-3


def test_grad_clipping():
    cfg = OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params, cfg)
    _, _, metrics = adamw_update(params, {"w": torch.full((4,), 1e6)},
                                 state, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    # clipped to norm 1, then normalised by Adam: each weight moves lr
    assert torch.allclose(params["w"], torch.full((4,), -1e-3), rtol=1e-4)


def test_bf16_moments_roundtrip():
    cfg = OptConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones((8, 8))}
    state = init_opt_state(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    p2, s2, _ = adamw_update(params, {"w": torch.full((8, 8), 0.1)}, state,
                             cfg)
    assert bool(torch.all(torch.isfinite(p2["w"])))
    assert s2["v"]["w"].dtype == torch.bfloat16


def test_compressed_training_converges():
    cfg = OptConfig(lr=0.05, warmup_steps=0, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params, cfg)
    err = init_error_state(params)
    for _ in range(150):
        g = {"w": 2 * (params["w"] - 1.0)}
        g, err = compress_grads(g, err)
        params, state, _ = adamw_update(params, g, state, cfg)
    assert float(torch.sum(torch.square(params["w"] - 1.0))) < 1e-2

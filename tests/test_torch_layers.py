"""Parity of the port's layer primitives and MLP with ``repro.models``.

Same numpy inputs (fixed seed) through the JAX function and its port.
Tolerances: fp32 2e-5 absolute on outputs of magnitude ~1 (summation
order and transcendental ulps only); bf16 2e-2 absolute (a few bf16 ulps:
the frameworks round intermediates at different places).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models import mlp as jmlp
from repro_torch.models import layers as tl
from repro_torch.models import mlp as tmlp
from test_torch_parity import TOL, assert_close, smoke_cfg, to_torch

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _inputs(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_rms_norm(name, jdt, tdt):
    x = _inputs((3, 5, 64))
    scale = 1.0 + 0.1 * _inputs((64,), seed=1)
    ref = jl.rms_norm(jnp.asarray(x, jdt), jnp.asarray(scale), 1e-5)
    out = tl.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                      1e-5)
    assert out.dtype == tdt
    assert_close(out, ref, TOL[name], "rms_norm")


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(name, jdt, tdt, theta):
    x = _inputs((2, 7, 4, 16))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 40, 41, 100, 200, 255, 3]],
                   np.int32)
    ref = jl.rope(jnp.asarray(x, jdt), jnp.asarray(pos), theta)
    out = tl.rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), theta)
    assert out.dtype == tdt
    # angles up to 255 rad: fp32 cos/sin of large arguments differ by an
    # ulp of the argument between libms
    assert_close(out, ref, max(TOL[name], 1e-4), "rope")


def test_sinusoidal_positions_and_dtypes():
    pos = np.array([[0, 3, 17, 200]], np.int32)
    ref = jl.sinusoidal_positions(jnp.asarray(pos), 32)
    out = tl.sinusoidal_positions(torch.from_numpy(pos), 32)
    assert_close(out, ref, 1e-4, "sinusoidal")
    assert tl.dtype_of("bfloat16") is torch.bfloat16
    assert tl.dtype_of("float32") is torch.float32


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(name, jdt, tdt, gated):
    import dataclasses
    cfg = dataclasses.replace(smoke_cfg("stablelm-1.6b", name),
                              mlp_gated=gated)
    D, Fd = cfg.d_model, cfg.d_ff
    p = {"wi": _inputs((D, Fd), 1) / 8, "wd": _inputs((Fd, D), 2) / 10}
    if gated:
        p["wg"] = _inputs((D, Fd), 3) / 8
    x = _inputs((2, 5, D))
    ref = jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x, jdt), cfg)
    out = tmlp.mlp({k: to_torch(v) for k, v in p.items()},
                   torch.from_numpy(x).to(tdt), cfg)
    assert out.dtype == tdt
    assert_close(out, ref, 2 * TOL[name] if name == "bfloat16" else 1e-4,
                 "mlp")


def test_matmul_f32_is_fp32_accumulation():
    a = torch.from_numpy(_inputs((4, 64))).bfloat16()
    b = torch.from_numpy(_inputs((64, 33), 1)).bfloat16()
    out = tl.matmul_f32(a, b)
    assert out.dtype == torch.float32
    ref = jnp.einsum("bd,dv->bv", jnp.asarray(a.float().numpy(), jnp.bfloat16),
                     jnp.asarray(b.float().numpy(), jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    assert_close(out, ref, 1e-4, "matmul_f32")


def test_init_helpers_use_the_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tl.dense_init(g1, (64, 32), torch.bfloat16)
    b = tl.dense_init(g2, (64, 32), torch.bfloat16)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert abs(a.float().std().item() - 64 ** -0.5) < 0.02
    n = tl.normal_init(torch.Generator().manual_seed(0), (1000,), 0.02)
    assert abs(n.std().item() - 0.02) < 0.003

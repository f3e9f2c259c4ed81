"""The port's Mamba2 block (zamba2's SSD) against ``repro.models.mamba``.

* ``_ssd_scan`` (plain torch) vs the JAX ``_ssd_scan`` on the same seeded
  inputs: S a multiple of the chunk with two and three chunks (the carried
  state), a ragged S (one chunk, the reference's rule), with and without
  an initial state, x/B/C in fp32 and bf16.
* ``_m2_forward(return_state=True)`` and ``_m2_step`` vs the reference's on
  the zamba2 smoke config, with the reference's own weights (one layer
  from ``_init_m2``), in fp32 and bf16 compute; a prompt shorter than the
  conv window (the conv tail left-padded with zeros, which is what a
  token-by-token decode from zeros holds).
* The port's SSD dual form against its own single-token recurrence.

Tolerances: the SSD in fp32 1e-5 absolute on outputs of magnitude ~1 (the
same fp32 arithmetic, summed in another order by XLA and by PyTorch); the
block in fp32 compute 2e-5 absolute, in bf16 compute 3e-2 x max(1, max
|reference|) (XLA and PyTorch round bf16 activations at different places,
and one bf16 ulp is 2**-8 of the magnitude); the dual form against the
recurrence 1e-4 of the output's magnitude (exp of cumulative sums against
step-by-step products).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jm
from repro_torch.models import mamba as tm
from repro_torch.params import from_reference
from test_torch_parity import assert_close, smoke_cfg, to_np, to_torch

ARCH = "zamba2-1.2b"
BLOCK_TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# the reference functions, jitted (one XLA program each instead of an
# eager dispatch per op; the config and flags are static)
j_ssd = jax.jit(jm._ssd_scan, static_argnums=(6,))
j_forward = jax.jit(jm._m2_forward, static_argnums=(2, 4))
j_step = jax.jit(jm._m2_step, static_argnums=(2,))


def _ssd_inputs(B, S, nh, hp, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    f32 = (lambda a: a.astype(np.float32))
    cast = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))) \
        if dtype == "bfloat16" else f32
    return (cast(rng.standard_normal((B, S, nh, hp))),
            f32(np.log1p(np.exp(rng.standard_normal((B, S, nh)))) * 0.1),
            f32(-np.exp(rng.standard_normal(nh) * 0.5)),
            cast(rng.standard_normal((B, S, N))),
            cast(rng.standard_normal((B, S, N))),
            f32(rng.standard_normal((B, nh, hp, N))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,chunk", [(2, 24, 8), (1, 32, 16), (2, 19, 8),
                                       (1, 5, 8)])
def test_ssd_scan_matches_jax(B, S, chunk, dtype):
    xh, dt, A, Bc, Cc, h0 = _ssd_inputs(B, S, 4, 8, 16, dtype)
    for init in (np.zeros_like(h0), h0):
        jy, jh = j_ssd(*(jnp.asarray(a) for a in
                         (xh, dt, A, Bc, Cc, init)), chunk)
        ty, th = tm._ssd_scan(*(to_torch(a) for a in
                                (xh, dt, A, Bc, Cc, init)), chunk)
        assert ty.dtype == th.dtype == torch.float32
        assert_close(ty, jy, 1e-5, "y")
        assert_close(th, jh, 1e-5, "final state")


@functools.lru_cache(maxsize=None)
def _ref_layer():
    """One Mamba2 layer of the reference (``_init_m2``, PRNGKey(0)) as
    numpy, built once: it depends on ``param_dtype`` only, not on the
    compute dtype."""
    jl = jax.jit(jm._init_m2, static_argnums=(1,))(
        jax.random.PRNGKey(0), smoke_cfg(ARCH, "float32"))
    return jax.tree_util.tree_map(np.asarray, jl)


def _layer_setup(dt):
    cfg = smoke_cfg(ARCH, dt)
    layer = _ref_layer()
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    return cfg, jl, from_reference(layer, cfg, device="cpu")


def _close(a, b, dt, what):
    """``BLOCK_TOL`` absolute in fp32; in bf16 relative to the magnitude."""
    scale = 1.0 if dt == "float32" else max(1.0, float(np.abs(to_np(b)).max()))
    assert_close(a, b, BLOCK_TOL[dt] * scale, what)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 13])
def test_m2_forward_with_state_matches_jax(dt, S):
    """S=16 is two SSD chunks of the smoke config's 8, S=13 one ragged
    chunk; the second call continues from the first call's state."""
    cfg, jl, tl = _layer_setup(dt)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, cdt)
    xt = to_torch(np.asarray(xj))
    jout, (jtail, jh) = j_forward(jl, xj, cfg, None, True)
    tout, (ttail, th) = tm.mamba_forward(tl, xt, cfg, return_state=True)
    assert tout.dtype == getattr(torch, dt) and th.dtype == torch.float32
    assert tuple(ttail.shape) == (2, cfg.ssm_conv - 1,
                                  cfg.d_inner + 2 * cfg.ssm_state)
    _close(tout, jout, dt, "block output")
    _close(ttail, jtail, dt, "conv tail")
    _close(th, jh, dt, "final state")
    # h0: continue from the returned state
    jout2 = j_forward(jl, xj, cfg, jh, False)
    tout2 = tm.mamba_forward(tl, xt, cfg, h0=th)
    _close(tout2, jout2, dt, "block output from h0")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_m2_step_matches_jax(dt):
    cfg, jl, tl = _layer_setup(dt)
    rng = np.random.default_rng(2)
    cdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    jstate = jm.init_mamba_state(cfg, 3, cdt)
    tstate = tm.init_mamba_state(cfg, 3, getattr(torch, dt), device="cpu")
    for t in range(5):
        x1 = jnp.asarray(rng.standard_normal((3, cfg.d_model)), cdt)
        jy, jstate = j_step(jl, x1, cfg, jstate)
        ty, tstate = tm.mamba_step(tl, to_torch(np.asarray(x1)), cfg,
                                   tstate)
        _close(ty, jy, dt, f"step {t} output")
    _close(tstate[0], jstate[0], dt, "conv buffer")
    _close(tstate[1], jstate[1], dt, "state")


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_conv_tail_is_token_by_token_state(S):
    """S < K-1: the tail is the zero-initialised buffer after S reference
    steps, and the output and final state equal S reference steps."""
    cfg, jl, tl = _layer_setup("float32")
    x = np.random.default_rng(5).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    tout, (ttail, th) = tm.mamba_forward(tl, to_torch(x), cfg,
                                         return_state=True)
    state = jm.init_mamba_state(cfg, 2)
    for t in range(S):
        jy, state = j_step(jl, jnp.asarray(x[:, t]), cfg, state)
        assert_close(tout[:, t], jy, BLOCK_TOL["float32"], f"output {t}")
    assert_close(ttail, state[0], 1e-5, "conv tail")
    assert_close(th, state[1], BLOCK_TOL["float32"], "state")


@pytest.mark.parametrize("S", [24, 21])
def test_ssd_equals_its_recurrence(S):
    """The dual form over S tokens (three chunks; one ragged chunk) against
    S single-token steps of the port from a zero state, fp32."""
    cfg, _, tl = _layer_setup("float32")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32))
    y, (tail, h) = tm.mamba_forward(tl, x, cfg, return_state=True)
    state = tm.init_mamba_state(cfg, 2, device="cpu")
    ys = []
    for t in range(S):
        yt, state = tm.mamba_step(tl, x[:, t], cfg, state)
        ys.append(yt)
    ys = torch.stack(ys, dim=1)
    assert (y - ys).abs().max() <= 1e-4 * ys.abs().max()
    assert (h - state[1]).abs().max() <= 1e-4 * state[1].abs().max()
    assert torch.allclose(tail, state[0], atol=1e-6)

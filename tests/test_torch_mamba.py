"""The port's Mamba1 block and K3's plain version against the JAX reference.

* ``mamba_scan_ref`` (the plain sequential scan K3 falls back to on the
  CPU) vs ``repro.kernels.ref.mamba_scan_ref`` (with a non-zero ``h0`` as
  well) and vs the Pallas ``mamba_scan`` in interpret mode, over the shapes
  of ``tests/test_kernels.py``; x, B and C in fp32 and bf16.
* ``_causal_conv``, ``_conv_step``, ``_m1_forward(return_state=True)`` and
  ``_m1_step`` vs ``repro.models.mamba`` on the falcon-mamba smoke config,
  with the reference's own weights.
* the conv tail of a prompt shorter than ``ssm_conv - 1``: left-padded with
  zeros, which is what a token-by-token decode from a zero state holds.

Tolerances: the plain scan vs the JAX sequential oracle 1e-5 absolute (the
same fp32 steps); vs the Pallas kernel 1e-4, as the reference's own test.
The block in fp32 compute 2e-5 (JAX's chunked associative scan and the
port's sequential scan sum in different orders); in bf16 compute 3e-2 (XLA
and PyTorch round bf16 activations at different places).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import mamba_scan as j_scan
from repro.kernels.ref import mamba_scan_ref as j_scan_ref
from repro.models import mamba as jm
from repro_torch.kernels import mamba_scan as scan_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.models import mamba as tm
from test_torch_parity import assert_close, ref_params, smoke_cfg, to_torch

BLOCK_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _scan_inputs(B, S, dI, N, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, dI)))) * 0.1
    x = rng.standard_normal((B, S, dI))
    Bc = rng.standard_normal((B, S, N))
    Cc = rng.standard_normal((B, S, N))
    A = -np.exp(rng.standard_normal((dI, N)) * 0.5)
    h0 = rng.standard_normal((B, dI, N))
    f32 = (lambda a: a.astype(np.float32))
    cast = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))) \
        if dtype == "bfloat16" else f32
    return f32(dt), cast(x), cast(Bc), cast(Cc), f32(A), f32(h0)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("B,S,dI,N", [(2, 64, 128, 16), (1, 96, 64, 8),
                                      (1, 37, 40, 16), (3, 5, 24, 32)])
def test_plain_scan_matches_jax_oracle_with_and_without_h0(B, S, dI, N,
                                                           dtype):
    dt, x, Bc, Cc, A, h0 = _scan_inputs(B, S, dI, N, dtype=dtype)
    for init in (None, h0):
        jy, jh = j_scan_ref(jnp.asarray(dt), jnp.asarray(A), jnp.asarray(Bc),
                            jnp.asarray(Cc), jnp.asarray(x),
                            None if init is None else jnp.asarray(init))
        ty, th = mamba_scan_ref(*(to_torch(a) for a in (dt, A, Bc, Cc, x)),
                                h0=None if init is None else to_torch(init))
        assert ty.dtype == th.dtype == torch.float32
        assert_close(ty, jy, 1e-5, "y")
        assert_close(th, jh, 1e-5, "hT")


@pytest.mark.parametrize("B,S,dI,N,block_d,chunk", [
    (2, 64, 128, 16, 64, 32),
    (1, 96, 64, 8, 64, 96),
    (1, 128, 256, 16, 128, 64),
])
def test_plain_scan_matches_pallas_kernel(B, S, dI, N, block_d, chunk):
    dt, x, Bc, Cc, A, _ = _scan_inputs(B, S, dI, N, seed=1)
    jy, jh = j_scan(jnp.asarray(dt), jnp.asarray(x), jnp.asarray(Bc),
                    jnp.asarray(Cc), jnp.asarray(A), block_d=block_d,
                    chunk=chunk, interpret=True)
    # the port's dispatch, on CPU tensors: the plain scan, no launch
    n0 = scan_mod.launches
    ty, th = ops.mamba_scan(*(to_torch(a) for a in (dt, x, Bc, Cc, A)))
    assert scan_mod.launches == n0
    assert_close(ty, jy, 1e-4, "y")
    assert_close(th, jh, 1e-4, "hT")


def test_cuda_entry_point_refuses_cpu_tensors():
    dt, x, Bc, Cc, A, _ = (to_torch(a) for a in _scan_inputs(1, 4, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A)


def _block_setup(dt):
    cfg = smoke_cfg("falcon-mamba-7b", dt)
    jp, tp = ref_params(cfg)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])
    tl = {k: v[0] for k, v in tp["blocks"].items()}
    return cfg, jl, tl


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_causal_conv_and_conv_step(dt):
    cfg, jl, tl = _block_setup(dt)
    cdt = jnp.dtype(dt)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, cfg.d_inner)).astype(np.float32)
    w, b = jl["conv_w"].astype(cdt), jl["conv_b"].astype(cdt)
    jx = jnp.asarray(x).astype(cdt)
    tx = to_torch(np.asarray(jx))
    assert_close(tm._causal_conv(tx, tl["conv_w"], tl["conv_b"]),
                 jm._causal_conv(jx, w, b), BLOCK_TOL[dt], "causal conv")
    buf = jx[:, :cfg.ssm_conv - 1]
    jy, jbuf = jm._conv_step(buf, jx[:, -1], w, b)
    ty, tbuf = tm._conv_step(to_torch(np.asarray(buf)), tx[:, -1],
                             tl["conv_w"], tl["conv_b"])
    assert_close(ty, jy, BLOCK_TOL[dt], "conv step")
    assert_close(tbuf, jbuf, 0.0, "conv step buffer")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_m1_forward_with_state(dt):
    cfg, jl, tl = _block_setup(dt)
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 13, cfg.d_model)),
                    jnp.dtype(dt))
    jout, (jtail, jh) = jm._m1_forward(jl, x, cfg, return_state=True)
    tx = to_torch(np.asarray(x))
    tout, (ttail, th) = tm.mamba_forward(tl, tx, cfg, return_state=True)
    assert tout.dtype == tx.dtype and th.dtype == torch.float32
    assert_close(tout, jout, BLOCK_TOL[dt], "block output")
    assert_close(ttail, jtail, BLOCK_TOL[dt], "conv tail")
    assert_close(th, jh, BLOCK_TOL[dt], "final state")
    # the two scan impls are one function on CPU tensors
    pout = tm.mamba_forward(tl, tx, cfg, impl="plain")
    assert torch.equal(pout, tout)
    with pytest.raises(ValueError, match="scan impl"):
        tm.mamba_forward(tl, tx, cfg, impl="chunked")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_m1_step(dt):
    cfg, jl, tl = _block_setup(dt)
    rng = np.random.default_rng(4)
    cdt = jnp.dtype(dt)
    x1 = jnp.asarray(rng.standard_normal((3, cfg.d_model)), cdt)
    buf = jnp.asarray(rng.standard_normal(
        (3, cfg.ssm_conv - 1, cfg.d_inner)), cdt)
    h = jnp.asarray(rng.standard_normal((3, cfg.d_inner, cfg.ssm_state)),
                    jnp.float32)
    jy, (jbuf, jh) = jm._m1_step(jl, x1, cfg, (buf, h))
    ty, (tbuf, th) = tm.mamba_step(tl, to_torch(np.asarray(x1)), cfg,
                                   (to_torch(np.asarray(buf)),
                                    to_torch(np.asarray(h))))
    assert_close(ty, jy, BLOCK_TOL[dt], "step output")
    assert_close(tbuf, jbuf, BLOCK_TOL[dt], "step conv buffer")
    assert_close(th, jh, BLOCK_TOL[dt], "step state")


@pytest.mark.parametrize("S", [1, 2])
def test_short_prompt_conv_tail_is_left_padded(S):
    """S < K-1: the tail is the zero-initialised buffer after S decode
    steps, and the final state equals S reference steps from zeros."""
    cfg, jl, tl = _block_setup("float32")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    tout, (ttail, th) = tm.mamba_forward(tl, to_torch(x), cfg,
                                         return_state=True)
    assert tuple(ttail.shape) == (2, cfg.ssm_conv - 1, cfg.d_inner)
    state = jm.init_mamba_state(cfg, 2)
    for t in range(S):
        jy, state = jm._m1_step(jl, jnp.asarray(x[:, t]), cfg, state)
        assert_close(tout[:, t], jy, BLOCK_TOL["float32"], f"output {t}")
    assert_close(ttail, state[0], 1e-5, "conv tail")
    assert_close(th, state[1], BLOCK_TOL["float32"], "state")


def test_init_mamba_state_and_mamba2_refusal():
    """Mamba1's and Mamba2's decode state: the reference's shapes and
    dtypes, zeros (Mamba2: conv over dI + 2N channels, h per head (nh, hp,
    N)); a config that is not an SSM is refused."""
    for arch in ("falcon-mamba-7b", "zamba2-1.2b"):
        cfg = smoke_cfg(arch)
        conv, h = tm.init_mamba_state(cfg, 3, torch.bfloat16, device="cpu")
        jconv, jh = jm.init_mamba_state(cfg, 3, jnp.bfloat16)
        assert tuple(conv.shape) == jconv.shape \
            and conv.dtype == torch.bfloat16
        assert tuple(h.shape) == jh.shape and h.dtype == torch.float32
        assert not conv.any() and not h.any()
    z2 = smoke_cfg("zamba2-1.2b")
    assert tuple(h.shape) == (3, z2.ssm_heads, z2.ssm_head_dim, z2.ssm_state)
    with pytest.raises(ValueError, match="not a Mamba1 or Mamba2"):
        tm.init_mamba_state(smoke_cfg("stablelm-1.6b"), 1, device="cpu")

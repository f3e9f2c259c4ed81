"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the same numpy inputs go through a JAX function of ``repro`` and its
counterpart in ``repro_torch``, and the outputs are compared as numpy.

Tolerances per compute dtype: float32 runs are tight (only the summation
order differs between the frameworks); bfloat16 runs allow a few bf16 ulps
of the output magnitude (bf16 rounds at different places in XLA and in
PyTorch)."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config
from repro.models import lm as jlm
from repro_torch.params import from_reference, to_torch

__all__ = ["to_np", "to_torch", "smoke_cfg", "ref_params", "assert_close",
           "TOL", "ARCHS"]

# the suite runs in several worker processes at once: keep each one's
# intra-op thread pool small so the smoke-size ops do not oversubscribe
torch.set_num_threads(2)

#: the dense smoke configs of the serving slice: plain MHA, qk_norm + GQA,
#: qkv_bias + GQA (+ bf16 params)
ARCHS = ("stablelm-1.6b", "qwen3-14b", "qwen2.5-32b")

#: absolute tolerance on outputs of magnitude ~1 (logits get their own)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def to_np(x) -> np.ndarray:
    """torch or JAX array -> float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def smoke_cfg(arch: str, compute_dtype: str = "bfloat16"):
    return dataclasses.replace(get_config(arch).smoke(),
                               compute_dtype=compute_dtype)


def ref_params(cfg, cast: bool = True):
    """(JAX params from PRNGKey(0), the port's copy on the CPU)."""
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                        device="cpu", cast=cast)
    return jp, tp


def assert_close(a, b, atol: float, what: str = "") -> float:
    a, b = to_np(a), to_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= atol, f"{what}: max abs err {err} > {atol}"
    return err


def test_to_np_widens_bf16_exactly_from_both_frameworks():
    import jax.numpy as jnp
    vals = np.array([1.0, -2.5, 3.140625, 65280.0], np.float32)  # bf16-exact
    t = torch.from_numpy(vals).bfloat16()
    j = jnp.asarray(vals, jnp.bfloat16)
    assert np.array_equal(to_np(t), vals) and np.array_equal(to_np(j), vals)
    assert np.array_equal(to_np(to_torch(np.asarray(j))), vals)


def test_assert_close_reports_the_error():
    assert assert_close(np.zeros(3), torch.zeros(3), 0.0) == 0.0
    try:
        assert_close(np.zeros(2), np.ones(2), 0.5, "demo")
    except AssertionError as e:
        assert "demo" in str(e)
    else:
        raise AssertionError("a difference of 1 passed a 0.5 tolerance")

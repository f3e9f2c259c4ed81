"""The param bridge: ``from_reference`` copies every leaf of the reference
tree name for name (bit-exact, bf16 leaves included), the load-time cast
rounds exactly as the reference's per-use ``astype``, and the port's own
``init_params`` gives the reference tree's names and shapes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.params import MATRICES, from_reference, init_params, \
    param_bytes
from test_torch_parity import ARCHS, smoke_cfg, to_np


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("arch", ARCHS)
def test_from_reference_copies_every_leaf_exactly(arch):
    cfg = smoke_cfg(arch)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = from_reference(jp, cfg, device="cpu", cast=False)
    jflat, tflat = dict(_flat(jp)), dict(_flat(tp))
    assert sorted(jflat) == sorted(tflat)
    for name, j in jflat.items():
        t = tflat[name]
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).split(".")[-1] == j.dtype.name, name
        if j.dtype.name == "bfloat16":     # compare the bit patterns
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  j.view(np.int16)), name
        else:
            assert np.array_equal(t.numpy(), j), name


@pytest.mark.parametrize("arch", ARCHS)
def test_load_time_cast_matches_per_use_astype(arch):
    cfg = smoke_cfg(arch)
    jp = jlm.init_params(cfg, jax.random.PRNGKey(0))
    tp = from_reference(jp, cfg, device="cpu", cast=True)
    cdt = jnp.bfloat16
    for name, j in _flat(jp):
        t = dict(_flat(tp))[name]
        leaf = name.split(".")[-1]
        if leaf in MATRICES:
            assert t.dtype == torch.bfloat16, name
            assert np.array_equal(to_np(t), to_np(j.astype(cdt))), name
        else:   # norms and biases stay in param_dtype
            assert str(t.dtype).split(".")[-1] == np.asarray(j).dtype.name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_names_and_shapes_match_reference(arch):
    cfg = smoke_cfg(arch)
    jp = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jflat, tflat = dict(_flat(jp)), dict(_flat(tp))
    assert sorted(jflat) == sorted(tflat)
    for name, j in jflat.items():
        assert tuple(tflat[name].shape) == tuple(j.shape), name
        want = torch.bfloat16 if name.split(".")[-1] in MATRICES \
            else getattr(torch, cfg.param_dtype)
        assert tflat[name].dtype == want, name
    # same seed, same weights; another seed, others
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    other = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(tp["blocks"]["wq"], again["blocks"]["wq"])
    assert not torch.equal(tp["blocks"]["wq"], other["blocks"]["wq"])
    # per-layer fan-in scale, as the reference's vmapped dense_init
    std = tp["blocks"]["wi"].float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.02


def test_param_bytes_count_bf16_matrices_and_fp32_norms():
    """Matrices resident in bf16 (2 B), norms in fp32 (4 B); at full width
    stablelm-1.6b's weights are then ~3.3 GB (6.6 GB if left fp32)."""
    cfg = smoke_cfg("stablelm-1.6b")
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = sum((2 if name.split(".")[-1] in MATRICES else 4) * v.numel()
               for name, v in _flat(tp))
    assert param_bytes(tp) == want
    assert 3.2e9 < 2 * get_config("stablelm-1.6b").param_count() < 3.4e9


def test_init_params_refuses_unported_families():
    for arch in ("qwen2-moe-a2.7b", "falcon-mamba-7b", "zamba2-1.2b"):
        with pytest.raises(ValueError):
            init_params(get_config(arch).smoke(), torch.Generator(),
                        device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal")
    cfg = smoke_cfg("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator())

"""The param bridge: ``from_reference`` copies every leaf of the reference
tree name for name (bit-exact, bf16 leaves included), the load-time cast
rounds exactly as the reference's per-use ``astype``, and the port's own
``init_params`` gives the reference tree's names and shapes — for the dense
smoke configs, the MoE trees (qwen2-moe, arctic), falcon-mamba's Mamba1
tree and zamba2's hybrid tree."""
import dataclasses
import math

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


MOE = ("qwen2-moe-a2.7b", "arctic-480b")
ALL_FAMILIES = ARCHS + MOE + ("falcon-mamba-7b", "zamba2-1.2b")


def _meta(g, shape, *a, dtype=torch.float32, **k):
    """A stand-in for the draws: an empty tensor on the meta device."""
    dtype = a[-1] if a and isinstance(a[-1], torch.dtype) else dtype
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", ALL_FAMILIES)
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


@pytest.mark.parametrize("arch", ALL_FAMILIES)
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
    # the padded vocabulary's embedding rows and head columns are zero
    V = cfg.vocab_size
    assert V < cfg.padded_vocab and not tp["embed"][V:].any()
    assert tp["embed"][V - 1].any()
    if "lm_head" in tp:
        assert not tp["lm_head"][:, V:].any() and tp["lm_head"][:, :V].any()


def test_init_params_mamba1_tree_matches_reference():
    """falcon-mamba smoke: the reference tree's names and shapes; matrices
    in bf16, ``A_log``/``ssm_D`` fp32, ``dt_bias`` in param_dtype, and the
    reference's distributions (A = 1..N per channel, D = 1, dt = softplus
    of the bias in [1e-3, 1e-1])."""
    cfg = smoke_cfg("falcon-mamba-7b")
    jp = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jflat, tflat = dict(_flat(jp)), dict(_flat(tp))
    assert sorted(jflat) == sorted(tflat)
    for name, j in jflat.items():
        leaf = name.split(".")[-1]
        assert tuple(tflat[name].shape) == tuple(j.shape), name
        want = torch.bfloat16 if leaf in MATRICES else \
            torch.float32 if leaf in ("A_log", "ssm_D") \
            else getattr(torch, cfg.param_dtype)
        assert tflat[name].dtype == want, name
    blk = tp["blocks"]
    N = cfg.ssm_state
    assert torch.equal(blk["A_log"], torch.log(
        torch.arange(1, N + 1.0)).expand_as(blk["A_log"]))
    assert torch.equal(blk["ssm_D"], torch.ones_like(blk["ssm_D"]))
    dt = torch.nn.functional.softplus(blk["dt_bias"].float())
    assert 1e-3 - 1e-6 <= dt.min() and dt.max() <= 1e-1 + 1e-6
    assert abs(blk["in_proj"].float().std().item()
               - cfg.d_model ** -0.5) < 0.02
    assert abs(blk["conv_w"].float().std().item() - 0.2) < 0.02


def test_mamba1_param_count_at_full_width(monkeypatch):
    """Full-width falcon-mamba-7b on the meta device (shapes only, nothing
    drawn): the port's tree holds exactly the reference tree's 7.27 B
    parameters, 14.56 GB with the matrices in bf16. ``cfg.param_count()``
    is short of both by L * (dI - D) + D = 266,240 (its Mamba1 formula
    counts two of the three per-channel vectors and a second norm per
    layer, and omits the final norm)."""
    from repro_torch import params as tparams
    cfg = get_config("falcon-mamba-7b")

    def meta(g, shape, *a, dtype=torch.float32, **k):
        dtype = a[-1] if a and isinstance(a[-1], torch.dtype) else dtype
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    monkeypatch.setattr(tparams, "dense_init", meta)
    monkeypatch.setattr(tparams, "normal_init", meta)
    tp = tparams.init_params(cfg, torch.Generator(), device="meta")
    n = sum(v.numel() for _, v in _flat(tp))
    jp = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    assert n == sum(math.prod(j.shape) for j in jax.tree_util.tree_leaves(jp))
    assert n - cfg.param_count() \
        == cfg.num_layers * (cfg.d_inner - cfg.d_model) + cfg.d_model
    assert 7.27e9 < n < 7.28e9
    assert 14.5e9 < param_bytes(tp) < 14.6e9


def test_init_params_hybrid_tree_matches_reference():
    """zamba2 smoke with two groups (5 layers, every 2): the reference
    tree's names and shapes (``gblocks`` (G, every, ...), ``tail_blocks``,
    ``shared_block`` with ``fused_proj``); matrices in bf16, ``A_log``,
    ``dt_bias`` and ``ssm_D`` fp32, ``ssm_norm`` and the norm scales in
    param_dtype, and ``_init_m2``'s distributions (A = linspace(1, 16) per
    head, D = 1, dt = softplus of the bias in [1e-3, 1e-1])."""
    cfg = dataclasses.replace(smoke_cfg("zamba2-1.2b"), num_layers=5)
    jp = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    tp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jflat, tflat = dict(_flat(jp)), dict(_flat(tp))
    assert sorted(jflat) == sorted(tflat)
    for name, j in jflat.items():
        leaf = name.split(".")[-1]
        assert tuple(tflat[name].shape) == tuple(j.shape), name
        want = torch.bfloat16 if leaf in MATRICES else \
            torch.float32 if leaf in ("A_log", "dt_bias", "ssm_D") \
            else getattr(torch, cfg.param_dtype)
        assert tflat[name].dtype == want, name
    gb = tp["gblocks"]
    nh = cfg.ssm_heads
    assert torch.equal(gb["A_log"], torch.log(
        torch.linspace(1.0, 16.0, nh)).expand_as(gb["A_log"]))
    assert torch.equal(gb["ssm_D"], torch.ones_like(gb["ssm_D"]))
    dt = torch.nn.functional.softplus(tp["tail_blocks"]["dt_bias"])
    assert 1e-3 - 1e-6 <= dt.min() and dt.max() <= 1e-1 + 1e-6
    # one draw per layer: the two groups' layers differ
    assert not torch.equal(gb["in_proj"][0, 0], gb["in_proj"][1, 0])
    assert abs(tp["shared_block"]["fused_proj"].float().std().item()
               - (2 * cfg.d_model) ** -0.5) < 0.02


def test_zamba2_param_count_at_full_width(monkeypatch):
    """Full-width zamba2-1.2b on the meta device (shapes only, nothing
    drawn): the port's tree holds exactly the reference tree's
    1,178,862,464 parameters, ~2.36 GB with the matrices in bf16.
    ``cfg.param_count()`` says 1,178,777,728, short of both by L * (dI +
    2N - D) + D = 84,736 (its Mamba2 formula omits ``conv_b`` and counts
    a second norm per layer, and it omits the final norm)."""
    from repro_torch import params as tparams
    cfg = get_config("zamba2-1.2b")

    def meta(g, shape, *a, dtype=torch.float32, **k):
        dtype = a[-1] if a and isinstance(a[-1], torch.dtype) else dtype
        return torch.empty(tuple(shape), dtype=dtype, device="meta")

    monkeypatch.setattr(tparams, "dense_init", meta)
    monkeypatch.setattr(tparams, "normal_init", meta)
    tp = tparams.init_params(cfg, torch.Generator(), device="meta")
    n = sum(v.numel() for _, v in _flat(tp))
    jp = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    assert n == sum(math.prod(j.shape) for j in jax.tree_util.tree_leaves(jp))
    assert n == 1_178_862_464
    assert cfg.param_count() == 1_178_777_728
    assert n - cfg.param_count() == cfg.num_layers * (
        cfg.d_inner + 2 * cfg.ssm_state - cfg.d_model) + cfg.d_model
    assert 2.35e9 < param_bytes(tp) < 2.37e9


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
    """init_params refuses no family any more: the MoE trees (qwen2-moe's
    shared experts, arctic's dense residual) match the reference's names,
    shapes and dtypes, with ``router`` in fp32 and qwen2-moe's
    ``shared_gate`` in its fp32 ``param_dtype`` (arctic's is bf16: its
    norms too); the experts' matrices and the shared and dense MLPs in the
    compute dtype; the reference's distributions (router N(0, 0.02),
    expert fan-in over every axis but the last, a zero shared gate)."""
    for arch in MOE:
        cfg = smoke_cfg(arch)
        jp = jax.eval_shape(lambda: jlm.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
        tp = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
        jflat, tflat = dict(_flat(jp)), dict(_flat(tp))
        assert sorted(jflat) == sorted(tflat)
        for name, j in jflat.items():
            leaf = name.split(".")[-1]
            assert tuple(tflat[name].shape) == tuple(j.shape), name
            want = torch.bfloat16 if leaf in MATRICES \
                else getattr(torch, j.dtype.name)
            assert tflat[name].dtype == want, name
        blk = tp["blocks"]
        assert blk["router"].dtype == torch.float32
        assert "router" not in MATRICES and "shared_gate" not in MATRICES
        assert abs(blk["router"].std().item() - 0.02) < 0.005
        E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        assert abs(blk["e_wi"].float().std().item() - (E * D) ** -0.5) \
            < 0.2 * (E * D) ** -0.5
        assert abs(blk["e_wd"].float().std().item() - (E * F) ** -0.5) \
            < 0.2 * (E * F) ** -0.5
        if cfg.shared_expert_d_ff:
            assert blk["shared_gate"].dtype == torch.float32
            assert not blk["shared_gate"].any()
        else:
            assert blk["dense_wi"].shape[-1] == cfg.d_ff
        # one draw per layer
        assert not torch.equal(blk["e_wi"][0], blk["e_wi"][1])


def test_moe_param_count_at_full_width(monkeypatch):
    """Full-width qwen2-moe-a2.7b on the meta device (shapes only, nothing
    drawn): the port's tree holds exactly the reference tree's
    14,316,308,480 parameters, 28.64 GB with the matrices in bf16, of
    which the experts are 24.91 GB; ``cfg.param_count()`` is short by the
    final norm's d_model."""
    from repro_torch import params as tparams
    from repro_torch.models import moe as tmoe
    cfg = get_config("qwen2-moe-a2.7b")
    for mod in (tparams, tmoe):
        monkeypatch.setattr(mod, "dense_init", _meta)
        monkeypatch.setattr(mod, "normal_init", _meta)
    tp = tparams.init_params(cfg, torch.Generator(), device="meta")
    n = sum(v.numel() for _, v in _flat(tp))
    jp = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    assert n == sum(math.prod(j.shape) for j in jax.tree_util.tree_leaves(jp))
    assert n == 14_316_308_480 == cfg.param_count() + cfg.d_model
    experts = sum(v.numel() * v.element_size() for name, v in _flat(tp)
                  if name.split(".")[-1] in ("e_wi", "e_wg", "e_wd"))
    assert experts == 24_914_165_760
    assert param_bytes(tp) == 28_639_109_120


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal")
    cfg = smoke_cfg("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator())

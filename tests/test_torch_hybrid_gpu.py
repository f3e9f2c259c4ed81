"""The zamba2 hybrid serving path on the card.

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere): its shared block's
prefill attention is K2, CUDA C++ for sm_90a with no interpret mode. Run on
the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_hybrid_gpu.py

* Under float32 compute the CUDA engine (K2 in each group's shared-block
  prefill, the slot decode) emits the CPU engine's greedy tokens on the
  zamba2 smoke config and on a 5-layer variant with two groups, with G
  launches of K2 per prefill.
* ``prefill`` with K2 against the plain chunked attention on CUDA: logits
  and the four returned state leaves, fp32 compute (1e-4 absolute; K2's
  fp32 path and the plain version differ in summation order).
* The SSD dual form against its single-token recurrence on CUDA, at the
  full-width head shapes (nh = hp = N = 64) and two chunks of 128:
  max |ssd - steps| <= 1e-4 x max |steps| on y and the final state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models import mamba as tm
from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

SSD_REL_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _setup(layers: int = 3):
    cfg = dataclasses.replace(get_config("zamba2-1.2b").smoke(),
                              compute_dtype="float32", num_layers=layers)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _to(params, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in params.items()}


@pytest.mark.parametrize("layers", [3, 5])
def test_cuda_engine_tokens_equal_cpu_engine(cuda, layers):
    cfg, params = _setup(layers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
               for s in (5, 9, 30, 1, 2, 17, 12)]
    geom = dict(decode_chunk=4, max_batch=4, max_seq_len=64)
    with ServeEngine(cfg, params, device="cpu", **geom) as eng:
        ref = eng.generate(prompts, max_new=14)
    ops.reset_launch_counts()
    with ServeEngine(cfg, _to(params, cuda), device=cuda, **geom) as eng:
        assert not eng.paged
        outs = eng.generate(prompts, max_new=14)
        stats = dict(eng.stats)
        assert len(eng._free_slots) == geom["max_batch"]
    counts = ops.launch_counts()
    for p, a, b in zip(prompts, outs, ref):
        assert a.tolist() == b.tolist(), f"prompt len {len(p)}"
    G = cfg.num_layers // cfg.hybrid_attn_every
    assert counts["flash_attention"] == G * stats["prefills"] > 0
    assert counts["paged_attention"] == counts["mamba_scan"] == 0


@pytest.mark.parametrize("S", [37, 16])
def test_prefill_flash_matches_chunked_on_cuda(cuda, S):
    cfg, params = _setup(5)
    params = _to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)).to(cuda)
    with torch.inference_mode():
        lf, cf = lm.prefill(cfg, params, toks, impl="flash")
        lp, cp = lm.prefill(cfg, params, toks, impl="chunked")
    pairs = [(lf, lp)] + [(a, b) for n in ("g_ssm", "tail_ssm")
                          for a, b in zip(cf[n], cp[n])] \
        + [(cf[n], cp[n]) for n in ("shared_k", "shared_v")]
    for a, b in pairs:
        assert a.shape == b.shape
        assert (a - b).abs().max().item() < 1e-4


def test_ssd_matches_recurrence_on_cuda(cuda):
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), num_layers=1,
                              hybrid_attn_every=0, compute_dtype="float32")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    p = {k: v[0] for k, v in params["blocks"].items()}
    S = 2 * cfg.ssm_chunk
    x = torch.randn((1, S, cfg.d_model), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    with torch.inference_mode():
        y, (_, h) = tm._m2_forward(p, x, cfg, return_state=True)
        state = tm.init_mamba_state(cfg, 1, torch.float32, cuda)
        ys = []
        for t in range(S):
            yt, state = tm._m2_step(p, x[:, t], cfg, state)
            ys.append(yt)
    ys = torch.stack(ys, dim=1)
    assert (y - ys).abs().max() <= SSD_REL_TOL * ys.abs().max()
    assert (h - state[1]).abs().max() <= SSD_REL_TOL * state[1].abs().max()

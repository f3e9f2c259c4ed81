"""K3 (the selective scan) and the Mamba1 serving path on the card.

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere): K3 is CUDA C++ for
sm_90a and has no interpret mode. Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_mamba_gpu.py

* K3 against its plain sequential version at the prefill path's shapes
  (B=1, dI=8192, N=16, S in {16, 57, 300}, bf16 x/B/C, fp32 dt), a ragged
  case (dI not a multiple of the 16-channel block, odd S), B=4, fp32
  inputs, a non-zero initial state and N=24 (the 8-lane variant); the
  edges of its chunk ring and lane groups (S = 1, S off the 8-step groups
  and 32-step chunks, dI off the 8-channel rows, N < 16, N = 32) and
  misaligned views; and the inputs it refuses.
* Under float32 compute the CUDA engine (K3 prefill, slot decode) emits the
  CPU engine's greedy tokens on falcon-mamba smoke, and a K3 prefill's
  logits match the plain scan's.

Tolerance for K3: max |kernel - plain| <= 1e-5 x max(1, max |plain|), on
y and on the final state. Both run the fp32 recurrence step by step; they
differ in expf against torch.exp, in FMA contraction and in the order of
the 16-term sum over the state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import mamba_scan as scan_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.models import lm
from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

K3_REL_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, S, dI, N, dtype, dev, seed=0, h0=False):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, dI)))) * 0.1
    t = (lambda a, d=torch.float32:                          # noqa: E731
         torch.from_numpy(a.astype(np.float32)).to(dev).to(d))
    return (t(dt), t(rng.standard_normal((B, S, dI)), dtype),
            t(rng.standard_normal((B, S, N)), dtype),
            t(rng.standard_normal((B, S, N)), dtype),
            t(-np.exp(rng.standard_normal((dI, N)) * 0.5)),
            t(rng.standard_normal((B, dI, N))) if h0 else None)


def _rel_err(a, b) -> float:
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


@pytest.mark.parametrize("B,S,dI,N,dtype,h0", [
    (1, 16, 8192, 16, torch.bfloat16, False),
    (1, 57, 8192, 16, torch.bfloat16, False),
    (1, 300, 8192, 16, torch.bfloat16, False),
    (1, 33, 1000, 16, torch.bfloat16, False),     # ragged dI, odd S
    (4, 300, 8192, 16, torch.bfloat16, False),
    (1, 300, 8192, 16, torch.float32, False),
    (2, 70, 8192, 16, torch.bfloat16, True),       # initial state
    (1, 65, 200, 24, torch.float32, True),         # 8 lanes a channel
    (3, 1, 16, 1, torch.float32, False),
])
def test_k3_matches_plain(cuda, B, S, dI, N, dtype, h0):
    dt, x, Bc, Cc, A, init = _inputs(B, S, dI, N, dtype, cuda, h0=h0)
    n0 = scan_mod.launches
    y, hT = ops.mamba_scan(dt, x, Bc, Cc, A, h0=init)
    yr, hr = mamba_scan_ref(dt, A, Bc, Cc, x, h0=init)
    torch.cuda.synchronize()
    assert scan_mod.launches == n0 + 1
    assert y.dtype == hT.dtype == torch.float32
    assert tuple(y.shape) == (B, S, dI) and tuple(hT.shape) == (B, dI, N)
    assert torch.isfinite(y).all() and torch.isfinite(hT).all()
    assert _rel_err(y, yr) <= K3_REL_TOL
    assert _rel_err(hT, hr) <= K3_REL_TOL


@pytest.mark.parametrize("B,S,dI,N,dtype,h0", [
    (1, 1, 8192, 16, torch.bfloat16, True),        # one step
    (2, 37, 520, 16, torch.bfloat16, True),        # S % 8, S % 32 != 0
    (1, 64, 512, 16, torch.float32, False),        # two whole chunks
    (1, 100, 1001, 5, torch.float32, True),        # dI % 8 != 0, N < 16
    (3, 45, 300, 32, torch.bfloat16, True),        # N = 32
    (1, 70, 96, 17, torch.bfloat16, False),        # 8 lanes, N = 17
])
def test_k3_edges(cuda, B, S, dI, N, dtype, h0):
    """The edges of the 4-states-per-thread layout and the 32-step chunk
    ring: S of one step and ragged against the 8-step groups and the
    chunks, dI off the 8-channel rows (element loads), N below a lane
    group's 4 states and over 16 (8 lanes per channel)."""
    dt, x, Bc, Cc, A, init = _inputs(B, S, dI, N, dtype, cuda, seed=S + N,
                                     h0=h0)
    y, hT = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, h0=init)
    yr, hr = mamba_scan_ref(dt, A, Bc, Cc, x, h0=init)
    assert torch.isfinite(y).all() and torch.isfinite(hT).all()
    assert _rel_err(y, yr) <= K3_REL_TOL
    assert _rel_err(hT, hr) <= K3_REL_TOL


def test_k3_misaligned_inputs(cuda):
    """dt and x views one element into their storage: the staging reads
    them element by element, with the same arithmetic."""
    dt, x, Bc, Cc, A, init = _inputs(1, 40, 256, 16, torch.bfloat16, cuda,
                                     h0=True)
    dts = torch.empty(dt.numel() + 1, device=cuda)[1:].view(dt.shape)
    xs = torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)[1:] \
        .view(x.shape)
    dts.copy_(dt)
    xs.copy_(x)
    assert dts.data_ptr() % 16 and xs.data_ptr() % 16
    y, hT = scan_mod.mamba_scan_cuda(dts, xs, Bc, Cc, A, h0=init)
    y0, h0 = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, h0=init)
    assert torch.equal(y, y0) and torch.equal(hT, h0)


def test_k3_refuses_what_it_does_not_take(cuda):
    dt, x, Bc, Cc, A, _ = _inputs(1, 8, 64, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="N=33"):
        big = _inputs(1, 8, 64, 33, torch.float32, cuda)
        scan_mod.mamba_scan_cuda(*big[:5])
    with pytest.raises(TypeError):
        scan_mod.mamba_scan_cuda(dt.bfloat16(), x, Bc, Cc, A)
    with pytest.raises(TypeError):
        scan_mod.mamba_scan_cuda(dt, x, Bc.float(), Cc, A)
    with pytest.raises(ValueError, match="contiguous"):
        scan_mod.mamba_scan_cuda(dt, x, Bc.transpose(1, 2).contiguous()
                                 .transpose(1, 2), Cc, A)
    with pytest.raises(ValueError, match="expected"):
        scan_mod.mamba_scan_cuda(dt, x, Bc[:, :4], Cc, A)
    with pytest.raises(ValueError, match="CUDA"):
        scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, h0=torch.zeros(1, 64, 16))


def _setup():
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").smoke(),
                              compute_dtype="float32")
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _to(params, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in params.items()}


def test_cuda_engine_tokens_equal_cpu_engine(cuda):
    cfg, params = _setup()
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
    assert counts["mamba_scan"] == cfg.num_layers * stats["prefills"] > 0
    assert counts["paged_attention"] == counts["flash_attention"] == 0


def test_prefill_kernel_matches_plain_on_cuda(cuda):
    cfg, params = _setup()
    params = _to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 37)).astype(np.int32)).to(cuda)
    with torch.inference_mode():
        lk, ck = lm.prefill(cfg, params, toks, impl="kernel")
        lp, cp = lm.prefill(cfg, params, toks, impl="plain")
    # layer l's conv tail is layer l's input, which carries the fp32
    # rounding of the scans below it
    for a, b in zip(ck["ssm"] + (lk,), cp["ssm"] + (lp,)):
        assert (a - b).abs().max().item() < 1e-4

"""K3's backward kernel, training of the Mamba families and the frontend
prefill on the card.

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere): the kernels are CUDA
C++ for sm_90a and have no interpret mode. Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_ssm_gpu.py

* The backward kernel (``MambaScan``) against ``torch.autograd``
  through the plain sequential scan: S on and off the 32-step chunks
  (S = 1 and 33 among them), a ragged dI (off the 64-channel blocks), N <
  16, an initial state, a final-state gradient, bf16 x/B/C (whose
  gradients come back in bf16); S over many chunks with a ragged last
  one; the inputs it refuses; K3's training entry point keeps the state
  before every chunk, and the backward's recomputed states are K3's bit
  for bit; two calls give the same bits.
* One fp32 batch's loss and every gradient of falcon-mamba and zamba2 (4
  layers at smoke width: zamba2 as 2 groups of 2) on the card against the
  CPU's, with remat; the launches of K3 and its backward.
* A frontend arch's prefill through K2 against the chunked plain path,
  in fp32 (internvl2-1b and musicgen-large, smoke width).

Tolerances: the backward, max |kernel - plain| <= 1e-4 x max |plain| per
gradient in fp32 (other orders of the sums over d, t and n; expf against
torch.exp) and 1e-2 with bf16 inputs (dx, dB, dC rounded to bf16 by both);
the step, loss 1e-5 relative and each leaf's gradient 1e-3 of its largest
magnitude; the prefill, logits 1e-4 of their spread.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import mamba_scan as scan_mod
from repro_torch.kernels import mamba_scan_bwd as bwd_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.models import lm
from repro_torch.params import init_params
from repro_torch.tree import leaves, tree_map, unflatten

pytestmark = pytest.mark.gpu

BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LOSS_REL, GRAD_REL, PREFILL_REL = 1e-5, 1e-3, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, S, dI, N, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, d=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(d)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, dI)))) * 0.1
    return [t(dt), t(rng.standard_normal((B, S, dI)), dtype),
            t(rng.standard_normal((B, S, N)), dtype),
            t(rng.standard_normal((B, S, N)), dtype),
            t(-np.exp(rng.standard_normal((dI, N)) * 0.5))]


def _grads(fn, ins, dy, dhT):
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    y, hT = fn(*ins)
    outs, gouts = [y], [dy]
    if dhT is not None:
        outs.append(hT)
        gouts.append(dhT)
    return torch.autograd.grad(outs, ins, gouts)


@pytest.mark.parametrize("B,S,dI,N,dtype,h0,fin", [
    (2, 250, 512, 16, torch.float32, False, False),
    (2, 256, 512, 16, torch.float32, False, True),
    (1, 1, 64, 16, torch.float32, False, False),
    (1, 33, 500, 16, torch.float32, True, True),
    (3, 70, 130, 12, torch.float32, True, False),
    (2, 250, 512, 16, torch.bfloat16, False, True),
])
def test_backward_matches_autograd_through_the_plain_scan(
        cuda, B, S, dI, N, dtype, h0, fin):
    ins = _inputs(B, S, dI, N, dtype, cuda, seed=S + dI)
    g = torch.Generator(cuda).manual_seed(1)
    init = torch.randn((B, dI, N), generator=g, device=cuda) if h0 else None
    dy = torch.randn((B, S, dI), generator=g, device=cuda)
    dhT = torch.randn((B, dI, N), generator=g, device=cuda) if fin else None
    n0 = ops.launch_counts()["mamba_scan_bwd"]
    got = _grads(lambda *a: scan_mod.MambaScan.apply(*a, init), ins, dy,
                 dhT)
    # two kernels a call: the reverse scan and its sums
    assert ops.launch_counts()["mamba_scan_bwd"] == n0 + 2
    want = _grads(lambda dt, x, b, c, a: mamba_scan_ref(dt, a, b, c, x,
                                                        h0=init),
                  ins, dy, dhT)
    for name, a, b in zip(("dt", "x", "B", "C", "A"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        assert err <= BWD_REL[dtype] * scale, (name, err, scale)


@pytest.mark.parametrize("S,dI", [(300, 512), (200, 500)])
def test_backward_over_many_chunks_matches_autograd(cuda, S, dI):
    """S over several chunks whose last is ragged (10 chunks, the last of
    12 steps; 7, the last of 8), a dI on and off the 64-channel blocks, an
    initial state and a final-state gradient."""
    B, N = 2, 16
    ins = _inputs(B, S, dI, N, torch.float32, cuda, seed=S)
    g = torch.Generator(cuda).manual_seed(2)
    init = torch.randn((B, dI, N), generator=g, device=cuda)
    dy = torch.randn((B, S, dI), generator=g, device=cuda)
    dhT = torch.randn((B, dI, N), generator=g, device=cuda)
    dt, x, Bc, Cc, A = ins
    _, _, hs = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, h0=init,
                                        save_states=True)
    n0 = ops.launch_counts()["mamba_scan_bwd"]
    got = bwd_mod.mamba_scan_bwd_cuda(dt, x, Bc, Cc, A, hs, dy, dhT)
    assert ops.launch_counts()["mamba_scan_bwd"] == n0 + 2
    want = _grads(lambda dt, x, b, c, a: mamba_scan_ref(dt, a, b, c, x,
                                                        h0=init),
                  ins, dy, dhT)
    for name, a, b in zip(("dt", "x", "B", "C", "A"), got, want):
        err = float((a - b).abs().max())
        assert err <= BWD_REL[torch.float32] * float(b.abs().max()), \
            (name, err)


@pytest.mark.parametrize("dtype,dI", [(torch.float32, 512),
                                      (torch.bfloat16, 512),
                                      (torch.float32, 500)])
def test_backward_gives_the_same_bits_twice(cuda, dtype, dI):
    dt, x, Bc, Cc, A = _inputs(2, 250, dI, 16, dtype, cuda, seed=9)
    _, _, hs = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, save_states=True)
    dy = torch.randn((2, 250, dI), generator=torch.Generator(
        cuda).manual_seed(3), device=cuda)
    one = bwd_mod.mamba_scan_bwd_cuda(dt, x, Bc, Cc, A, hs, dy)
    two = bwd_mod.mamba_scan_bwd_cuda(dt, x, Bc, Cc, A, hs, dy)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_backward_recomputes_k3s_states_bit_for_bit(cuda):
    """With dy one at channel 300 and zero elsewhere, dC_t[n] is h_t[300,
    n] summed with zeros; K3 with C the n-th unit vector gives y_t[d] =
    h_t[d, n] the same way (fp32)."""
    B, S, dI, N, dstar = 2, 250, 512, 16, 300
    dt, x, Bc, Cc, A = _inputs(B, S, dI, N, torch.float32, cuda, seed=4)
    _, _, hs = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, save_states=True)
    dy = torch.zeros((B, S, dI), device=cuda)
    dy[:, :, dstar] = 1.0
    dC = bwd_mod.mamba_scan_bwd_cuda(dt, x, Bc, Cc, A, hs, dy)[3]
    for n in range(N):
        e = torch.zeros((B, S, N), device=cuda)
        e[:, :, n] = 1.0
        y, _ = scan_mod.mamba_scan_cuda(dt, x, Bc, e, A)
        assert torch.equal(dC[:, :, n], y[:, :, dstar]), n


def test_training_entry_keeps_the_state_before_each_chunk(cuda):
    dt, x, Bc, Cc, A = _inputs(2, 70, 96, 16, torch.float32, cuda)
    y, hT, hs = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, save_states=True)
    y0, h0 = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A)
    assert torch.equal(y, y0) and torch.equal(hT, h0)
    assert tuple(hs.shape) == (2, 3, 96, 16)
    assert float(hs[:, 0].abs().max()) == 0.0
    for c in (1, 2):      # the state after 32 c steps
        _, hc = scan_mod.mamba_scan_cuda(
            dt[:, :32 * c].contiguous(), x[:, :32 * c].contiguous(),
            Bc[:, :32 * c].contiguous(), Cc[:, :32 * c].contiguous(), A)
        assert torch.equal(hs[:, c], hc)


def test_backward_refuses_what_it_does_not_take(cuda):
    dt, x, Bc, Cc, A = _inputs(1, 40, 64, 24, torch.float32, cuda)
    leaves_ = [t.requires_grad_(True) for t in (dt, x, Bc, Cc, A)]
    with pytest.raises(ValueError, match="state size"):
        scan_mod.mamba_scan(*leaves_)
    with pytest.raises(ValueError, match="h0 takes no gradient"):
        scan_mod.mamba_scan(*leaves_, h0=torch.zeros(
            (1, 64, 24), device=cuda, requires_grad=True))
    dt, x, Bc, Cc, A = _inputs(1, 40, 64, 16, torch.float32, cuda)
    _, _, hs = scan_mod.mamba_scan_cuda(dt, x, Bc, Cc, A, save_states=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bwd_mod.mamba_scan_bwd_cuda(dt.cpu(), x, Bc, Cc, A, hs, dt)
    with pytest.raises(ValueError, match="expected"):
        bwd_mod.mamba_scan_bwd_cuda(dt, x, Bc, Cc, A, hs[:, :1], dt)
    # no gradient needed: K3 alone, no states kept
    n0 = ops.launch_counts()
    y, _ = scan_mod.mamba_scan(dt, x, Bc, Cc, A)
    assert not y.requires_grad
    n1 = ops.launch_counts()
    assert n1["mamba_scan"] == n0["mamba_scan"] + 1
    assert n1["mamba_scan_bwd"] == n0["mamba_scan_bwd"]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _named(tree[k],
                                                        f"{prefix}{k}.")]
    return [prefix[:-1]]


@pytest.mark.parametrize("arch,every", [("falcon-mamba-7b", 0),
                                        ("zamba2-1.2b", 2)])
def test_step_on_the_card_matches_the_cpu(cuda, arch, every):
    cfg = dataclasses.replace(get_config(arch).smoke(), num_layers=4,
                              compute_dtype="float32", remat=True)
    if every:
        cfg = dataclasses.replace(cfg, hybrid_attn_every=every)
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       cast=False)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 45)).astype(np.int32))
    got = {}
    ops.reset_launch_counts()
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), base)
        flat = [t.detach().requires_grad_(True) for t in leaves(p)]
        total, _ = lm.loss_fn(cfg, unflatten(p, flat),
                              {"tokens": toks.to(dev)})
        got[str(dev)] = (float(total.detach()), [
            g.cpu() for g in torch.autograd.grad(total, flat)])
    counts = ops.launch_counts()
    if cfg.ssm_version == 1:   # remat: K3 twice a layer, its backward
        # once (two kernels a call)
        assert counts["mamba_scan"] == counts["mamba_scan_bwd"] == 8
    (lc, gc_), (lg, gg) = got["cpu"], got[str(cuda)]
    assert abs(lg - lc) <= LOSS_REL * abs(lc), (lg, lc)
    for name, a, b in zip(_named(base), gg, gc_):
        err = float((a - b).abs().max())
        assert err <= GRAD_REL * float(b.abs().max()), (name, err)


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_frontend_prefill_through_k2_matches_the_chunked_path(cuda, arch):
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              compute_dtype="float32")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 29))
                            .astype(np.int32)).to(cuda)
    fe = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)).to(cuda)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got, cache = lm.prefill(cfg, params, toks, frontend_embeds=fe)
        assert ops.launch_counts()["flash_attention"] == cfg.num_layers
        want, ref = lm.prefill(cfg, params, toks, impl="chunked",
                               frontend_embeds=fe)
    assert int(cache["pos"]) == cfg.frontend_tokens + 29
    spread = float(want.max() - want.min())
    assert float((got - want).abs().max()) <= PREFILL_REL * spread
    for k in ("k", "v"):
        assert float((cache[k] - ref[k]).abs().max()) <= 1e-4 * float(
            ref[k].abs().max())

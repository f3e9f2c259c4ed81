"""Each plain reference against the program at smoke size, both in
float32 on the CPU, on the same weights: teacher-forced logits and the
training loss."""
import dataclasses

import pytest
import torch

from perfbench import weights
from perfbench.harness import load_module
from perfbench.tests import tiny

CASES = [(tiny.DENSE, "dense"), (tiny.MAMBA, "mamba1")]


def _setup(conf, family):
    from repro_torch.configs import get_config
    ref = load_module(tiny.BENCH / "reference" / f"{family}.py")
    cfg = dataclasses.replace(get_config(conf["port_arch"]),
                              compute_dtype="float32")
    flat = weights.make(ref.shapes(conf), 2 ** 31 + 17, torch.device("cpu"),
                        served=False, vocab=conf["vocab_size"])
    toks = weights.rng(5, 0).integers(0, conf["vocab_size"], size=(2, 24))
    return ref, cfg, flat, torch.from_numpy(toks)


@pytest.mark.parametrize("conf,family", CASES, ids=["dense", "mamba1"])
def test_reference_logits_match_the_program(conf, family):
    from repro_torch.models import lm
    ref, cfg, flat, toks = _setup(conf, family)
    for name, want in ref.port_fields(conf).items():
        if name != "compute_dtype":
            assert getattr(cfg, name) == want, name
    with torch.no_grad():
        got, _ = lm.forward(cfg, weights.tree(flat), toks)
    for b in range(toks.shape[0]):
        want = ref.logits(conf, flat, toks[b], 0)
        torch.testing.assert_close(got[b], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("conf,family", CASES, ids=["dense", "mamba1"])
def test_reference_loss_and_gradients_match_the_program(conf, family):
    from repro_torch.models import lm
    ref, cfg, flat, toks = _setup(conf, family)
    leaves = {n: t.clone().requires_grad_(True) for n, t in flat.items()}
    want = ref.loss(conf, leaves, toks)
    gw = torch.autograd.grad(want, list(leaves.values()))
    leaves2 = {n: t.clone().requires_grad_(True) for n, t in flat.items()}
    got, _ = lm.loss_fn(cfg, weights.tree(leaves2), {"tokens": toks})
    gg = torch.autograd.grad(got, list(leaves2.values()))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("conf,family", CASES, ids=["dense", "mamba1"])
def test_control_precision_moves_the_logits(conf, family):
    ref, cfg, flat, toks = _setup(conf, family)
    a = ref.logits(conf, flat, toks[0], 0, "fp32")
    b = ref.logits(conf, flat, toks[0], 0, "fp8")
    assert (a - b).abs().max() > 1e-3

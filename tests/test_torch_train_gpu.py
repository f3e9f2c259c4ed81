"""The port's training path on the card (stablelm-1.6b's smoke config).

Needs an NVIDIA GPU (``gpu`` marker; skips elsewhere). Run on the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_gpu.py

* In fp32 compute the CUDA trainer's 8-step loss and grad-norm curve
  equals the CPU trainer's from the same weights within 1e-5 relative
  (fp32 matmuls stay fp32 on CUDA: TF32 is off by default; the embedding
  backward's atomics and cuBLAS's summation order are the differences).
* A checkpoint saved from the card restores on the CPU bit for bit.
* A bf16-compute step on the card gives a finite loss and grad norm.
* After an injected failure the CUDA trainer restores the last checkpoint
  and the re-run step's loss equals the first run's within 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.params import init_params
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import leaves, tree_map

pytestmark = pytest.mark.gpu

REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg(dt="float32"):
    return dataclasses.replace(get_config("stablelm-1.6b").smoke(),
                               compute_dtype=dt)


class _CpuDrawn(Trainer):
    """Weights drawn on the CPU generator, then moved to the device, so a
    CPU and a CUDA trainer start from the same numbers."""

    def init_state(self):
        g = torch.Generator().manual_seed(self.tc.seed)
        params = tree_map(lambda t: t.to(self.device),
                          init_params(self.cfg, g, device="cpu", cast=False))
        return {"params": params, "opt": init_opt_state(params, self.opt),
                "step": 0}


def _run(device, ckpt_dir=None, **kw):
    tc = TrainerConfig(**{"total_steps": 8, "ckpt_every": 100,
                          "log_every": 1, **kw})
    tr = _CpuDrawn(_cfg(), tc, batch=4, seq_len=32,
                   opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=8),
                   ckpt_dir=ckpt_dir, device=device)
    return tr, tr.run()


def test_cuda_loss_curve_equals_cpu(cuda):
    _, want = _run("cpu")
    _, got = _run(cuda)
    for g, w in zip(got["history"], want["history"], strict=True):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= REL * abs(w[k]), (g["step"], k)


def test_checkpoint_from_card_restores_on_cpu_bit_for_bit(cuda, tmp_path):
    tr, out = _run(cuda, ckpt_dir=str(tmp_path), total_steps=2,
                   ckpt_every=2)
    state = {"params": out["state"]["params"], "opt": out["state"]["opt"]}
    example = tree_map(lambda t: torch.empty_like(t, device="cpu"), state)
    step, got = tr.ckpt.restore_latest(example, device="cpu")
    assert step == 2
    for a, b in zip(leaves(got), leaves(state)):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b.cpu())


def test_bf16_step_is_finite(cuda):
    cfg = _cfg("bfloat16")
    g = torch.Generator(device=cuda).manual_seed(0)
    params = init_params(cfg, g, device=cuda, cast=False)
    opt = OptConfig()
    state = init_opt_state(params, opt)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(cuda)
    _, state, m = make_train_step(cfg, opt, microbatches=2)(
        params, state, {"tokens": toks})
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert int(state["count"]) == 1


def test_restart_reruns_a_step_with_the_same_loss(cuda, tmp_path):
    _, out = _run(cuda, ckpt_dir=str(tmp_path), total_steps=4,
                  ckpt_every=2, fail_at_step=3)
    assert out["restarts"] == 1 and out["state"]["step"] == 4
    first, again = [h["loss"] for h in out["history"] if h["step"] == 2]
    assert abs(first - again) <= REL * abs(first)

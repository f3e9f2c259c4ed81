"""The port's trainer-as-taskflow: the four scenarios of
``tests/test_trainer.py`` on stablelm-1.6b's smoke config (runs and
checkpoints; restarts after an injected failure; resumes across runs;
fails without checkpointing), and the loss curve of the JAX ``Trainer``.

The curve: from the reference's ``init_params(PRNGKey(0))`` weights
carried across, 8 steps at batch 4 x seq 32 in fp32 compute on the same
synthetic batches, every step's loss and grad norm within 1e-5 relative
of the JAX trainer's (measured: at most 3.1e-7 and 2.0e-7; fp32
arithmetic in another order, compounded over 8 AdamW steps).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import lm as jlm
from repro.optim.adamw import OptConfig as JOptConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core import TaskError
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.params import from_reference
from repro_torch.train import Trainer, TrainerConfig

CURVE_REL = 1e-5
CURVE = dict(total_steps=8, ckpt_every=100, log_every=1)
CURVE_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=8)


def _cfg():
    return get_config("stablelm-1.6b").smoke()


def test_trainer_runs_and_checkpoints(tmp_path):
    tc = TrainerConfig(total_steps=6, ckpt_every=3, log_every=2,
                       microbatches=1)
    tr = Trainer(_cfg(), tc, batch=2, seq_len=32,
                 opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=6),
                 ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    out = tr.run()
    assert out["state"]["step"] == 6
    assert out["restarts"] == 0
    assert [h["step"] for h in out["history"]] == [0, 2, 4, 5]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert tr.ckpt.all_steps() == [3, 6]


def test_trainer_restarts_from_checkpoint_after_failure(tmp_path):
    tc = TrainerConfig(total_steps=10, ckpt_every=4, log_every=1,
                       fail_at_step=6, max_restarts=2, microbatches=2)
    tr = Trainer(_cfg(), tc, batch=4, seq_len=32,
                 opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                 ckpt_dir=str(tmp_path / "ckpt"), device="cpu")
    out = tr.run()
    assert out["restarts"] == 1
    assert out["state"]["step"] == 10
    steps = [h["step"] for h in out["history"]]
    assert 5 in steps and steps.count(5) >= 2   # 5 re-ran after restore(4)
    first, again = [h["loss"] for h in out["history"] if h["step"] == 5][:2]
    assert first == again       # the same weights and batch, on the CPU


def test_trainer_resumes_across_runs(tmp_path):
    d = str(tmp_path / "ckpt")
    tc1 = TrainerConfig(total_steps=4, ckpt_every=2, log_every=1)
    Trainer(_cfg(), tc1, batch=2, seq_len=32, ckpt_dir=d, device="cpu").run()
    tc2 = TrainerConfig(total_steps=8, ckpt_every=2, log_every=1)
    out = Trainer(_cfg(), tc2, batch=2, seq_len=32, ckpt_dir=d,
                  device="cpu").run()
    assert min(h["step"] for h in out["history"]) >= 4
    assert out["state"]["step"] == 8


def test_trainer_fails_without_checkpointing():
    tc = TrainerConfig(total_steps=5, fail_at_step=2, max_restarts=2)
    tr = Trainer(_cfg(), tc, batch=2, seq_len=32, ckpt_dir=None,
                 device="cpu")
    with pytest.raises(TaskError):
        tr.run()


def test_trainer_without_cuda_raises_unless_given_a_device():
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_cfg(), TrainerConfig(total_steps=1), batch=1, seq_len=8)


@functools.lru_cache(maxsize=None)
def _jax_curve():
    cfg = dataclasses.replace(_cfg(), compute_dtype="float32")
    out = JTrainer(cfg, JTrainerConfig(**CURVE), batch=4, seq_len=32,
                   opt=JOptConfig(**CURVE_OPT)).run()
    params = jax.tree_util.tree_map(      # JTrainer.init_state's weights
        np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0)))
    return cfg, params, out["history"]


class _FromReference(Trainer):
    """The port's trainer started from the reference's initial weights."""

    def __init__(self, tree, *a, **kw):
        super().__init__(*a, **kw)
        self._tree = tree

    def init_state(self):
        params = from_reference(self._tree, self.cfg, device=self.device,
                                cast=False)
        return {"params": params, "opt": init_opt_state(params, self.opt),
                "step": 0}


def test_loss_curve_matches_reference_trainer():
    cfg, tree, want = _jax_curve()
    out = _FromReference(tree, cfg, TrainerConfig(**CURVE), batch=4,
                         seq_len=32, opt=OptConfig(**CURVE_OPT),
                         device="cpu").run()
    got = out["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want] \
        == list(range(8))
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(g[k] - w[k]) <= CURVE_REL * abs(w[k]), (g["step"], k,
                                                              g[k], w[k])
    assert got[-1]["loss"] < got[0]["loss"]


def test_launcher_runs_on_cpu_and_raises_without_a_device(capsys,
                                                          monkeypatch):
    import json

    import torch

    from repro_torch.launch import train as launch
    launch.main(["--device", "cpu", "--steps", "4", "--log-every", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"final_loss", "first_loss", "tokens_per_s"}
    assert np.isfinite(last["final_loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--steps", "4"])

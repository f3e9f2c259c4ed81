"""``correct`` comes out false when the timed path is broken underneath:
a served token altered where it is produced; a training step that leaves
its state unchanged; half of each batch left out, the mean taken over
the rest. Each tiny cell runs whole on the CPU, the look for a card
skipped."""
import json

import numpy as np
import pytest

from perfbench import harness
from perfbench.harness import main
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def _jax_of_other_tests(monkeypatch):
    """Test files that ran before in this worker may have loaded JAX and
    the JAX package; whether the benchmark loads them is
    test_perfbench_imports's question, asked in processes of their own."""
    monkeypatch.setattr(harness, "loaded_forbidden", lambda: [])


def _line(root, cell, capsys):
    rc = main(["--workload", cell, "--seed", str(2 ** 31 + 7), "--seconds",
               "2", "--trace", "0"], root=root, device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["dense-serve", "mamba-serve"])
def test_an_altered_token_fails(cell, tmp_path, capsys, monkeypatch):
    root = tiny.build(tmp_path)
    assert _line(root, cell, capsys)["correct"]
    from repro_torch.serve.scheduler import ServeRequest
    orig = ServeRequest.set_result

    def altered(self, tokens):
        tokens = np.array(tokens)
        tokens[len(tokens) // 2] = (tokens[len(tokens) // 2] + 1) % 503
        orig(self, tokens)

    monkeypatch.setattr(ServeRequest, "set_result", altered)
    line = _line(root, cell, capsys)
    assert not line["correct"]
    assert line["compared"]["logit_gap"]["value"] > \
        line["compared"]["logit_gap"]["limit"]


def _break_step(monkeypatch, how):
    import repro_torch.train.trainer as trainer
    make = trainer.make_train_step

    def broken(*a, **k):
        step = make(*a, **k)

        def run(params, opt_state, batch):
            if how == "unchanged":
                from repro_torch.tree import tree_map
                snap = tree_map(lambda t: t.clone(), params)
                p, o, metrics = step(params, opt_state, batch)
                tree_map(lambda t, s: t.copy_(s), p, snap)
                return p, o, metrics
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(params, opt_state, half)
        return run

    monkeypatch.setattr(trainer, "make_train_step", broken)


@pytest.mark.parametrize("cell", ["dense-train", "mamba-train"])
@pytest.mark.parametrize("how", ["unchanged", "half_batch"])
def test_a_broken_step_fails(cell, how, tmp_path, capsys, monkeypatch):
    root = tiny.build(tmp_path)
    _break_step(monkeypatch, how)
    line = _line(root, cell, capsys)
    assert not line["correct"], line["compared"]

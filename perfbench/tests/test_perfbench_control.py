"""The control of ``correct`` at a size a test run holds: the float8
reference put in the program's place reads wider gaps than the program
(bfloat16) does, on the same prompts and served tokens (at this size a
few dozen tokens: over several seeds, not on each); a training step in
float8, or on half of each batch, reads over the tiny cells' limits."""
import json

import pytest
import torch

from perfbench import control, harness
from perfbench.tests import tiny


def test_serve_control_reads_over_the_program(tmp_path, capsys):
    root = tiny.build(tmp_path)
    spec = harness.load_spec(root, "dense-serve")
    seeds = [2 ** 31 + 1, 2 ** 31 + 7, 11, 12]
    control.run_readings(spec, seeds, 2, len(seeds), torch.device("cpu"))
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    lim = spec.cell["limits"]["logit_gap"]
    assert len(rows) == len(seeds)
    for row in rows:
        assert row["unserved"] == 0 and row["logit_gap"] <= lim, row
    assert sum(r["control_gap"] for r in rows) > \
        3 * sum(r["logit_gap"] for r in rows), rows
    assert max(r["control_gap"] for r in rows) > lim


@pytest.mark.parametrize("cell", ["dense-train", "mamba-train"])
def test_train_control_and_fault_read_over_the_limits(cell, tmp_path,
                                                      capsys):
    root = tiny.build(tmp_path)
    spec = harness.load_spec(root, cell)
    control.run_readings(spec, [2 ** 31 + 3], 0, 0, torch.device("cpu"))
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    lim = spec.cell["limits"]
    for name in ("control", "half_batch"):
        assert any(row[name][k] > lim[k] for k in lim), (name, row)

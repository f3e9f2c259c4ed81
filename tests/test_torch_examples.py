"""The port's examples (``src/repro_torch/examples/``) on the CPU, at small
sizes, against the reference scripts in ``examples/`` where they print
comparable numbers.

``placement_loop``: the reference script runs in-process (``runpy``) with
the same arguments; its wirelength history is read from the condition
task's closure. The iteration count must be equal and every wirelength
within 1e-4 relative (fp32 sums in another order; the loop stops on a
relative improvement below ``--tol``, a data-dependent test). The serving
and training examples have random weights drawn by another generator than
the reference's, so they are held to their own invariants; the LSDNN
example's rows must carry every name of the reference rows.
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core
from repro_torch.examples import (lsdnn_inference, placement_loop,
                                  serve_lm, train_lm)

ROOT = Path(__file__).resolve().parents[1]
PLACEMENT_ARGS = ["--cells", "256", "--nets", "512", "--max-iters", "200",
                  "--tol", "0.01"]


def _reference_placement(monkeypatch, args):
    """Run ``examples/placement_loop.py`` with ``args``; return its state
    dict (wirelength history and iteration count)."""
    graphs = []
    run = repro.core.Executor.run

    def record(self, tf, *a, **kw):
        graphs.append(tf)
        return run(self, tf, *a, **kw)

    monkeypatch.setattr(repro.core.Executor, "run", record)
    monkeypatch.setattr(sys, "argv", ["placement_loop.py", *args])
    runpy.run_path(str(ROOT / "examples" / "placement_loop.py"),
                   run_name="__main__")
    (score,) = [n.fn for n in graphs[0]._nodes if n.name == "converged?"]
    cells = dict(zip(score.__code__.co_freevars, score.__closure__))
    return cells["state"].cell_contents


def test_placement_loop_matches_the_reference(monkeypatch):
    ref = _reference_placement(monkeypatch, PLACEMENT_ARGS)
    got = placement_loop.main([*PLACEMENT_ARGS, "--device", "cpu"])
    assert got["iterations"] == ref["it"]
    assert 1 < got["iterations"] < 200        # stopped on the tolerance
    assert got["tasks"] == 4
    np.testing.assert_allclose(got["history"], ref["history"], rtol=1e-4)
    assert got["history"][-1] < got["history"][0]


def test_placement_loop_without_cuda_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        placement_loop.main(PLACEMENT_ARGS)


def test_serve_lm_runs_its_three_demos():
    out = serve_lm.main(["--device", "cpu", "--arch", "stablelm-1.6b",
                         "--batch", "4", "--prompt-len", "16",
                         "--max-new", "8", "--decode-chunk", "4"])
    assert [len(o) for o in out["burst"]] == [8] * 4
    assert "pump" in out["mixed_kinds"] and "prefill" in out["mixed_kinds"]
    ra, rb = out["join"]
    assert len(ra) == 8 and len(rb) == 8
    st = out["stats"]
    # warm-up (4) + burst (4) + mixed (4) + join (2)
    assert st["retired"] == 14 and st["tokens_out"] > 0


def test_train_lm_loss_falls_and_decodes():
    out = train_lm.main(["--device", "cpu", "--steps", "8"])
    losses = [h["loss"] for h in out["history"]]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert len(out["sample"]) == 16


def test_lsdnn_inference_rows_carry_the_reference_names():
    rows = lsdnn_inference.main(["--device", "cpu", "--layers", "8",
                                 "--neurons", "64", "--passes", "2"])
    names = {r[0] for r in rows}
    # the rows of benchmarks/fig13_lsdnn.py::bench, which
    # examples/lsdnn_inference.py prints
    ref = {f"fig13/{k}" for k in (
        "sequential_ms", "sequential_launches", "unrolled_ms",
        "unrolled_launches", "unrolled_tasks", "taskflow_ms",
        "taskflow_launches", "taskflow_tasks", "result_max_err",
        "peak_rss_mb")}
    assert ref <= names
    vals = dict((r[0], r[1]) for r in rows)
    assert vals["fig13/result_max_err"] == 0.0
    assert vals["fig13/taskflow_launches"] == 2.0

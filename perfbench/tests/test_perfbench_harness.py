"""The harness runs a cell from files alone: a throwaway configuration,
traffic mix, cell and metric, added as files and entries only, found by
name; and ``run.py`` prints no result where it cannot run."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.harness import main
from perfbench.tests import tiny

EXTRA_METRIC = '''
"""Answers finished in the window (a throwaway reader)."""


def read(run):
    if run.steps is not None:
        return None
    w0, w1 = run.window
    return sum(q.finish is not None and w0 <= q.finish < w1
               for q in run.requests)
'''


@pytest.fixture(autouse=True)
def _jax_of_other_tests(monkeypatch):
    """Test files that ran before in this worker may have loaded JAX and
    the JAX package; whether the benchmark loads them is
    test_perfbench_imports's question, asked in processes of their own."""
    monkeypatch.setattr(harness, "loaded_forbidden", lambda: [])


def _run(root, cell, capsys, trace=0, seed=2 ** 31 + 99):
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds", "2",
               "--trace", str(trace)], root=root, device="cpu")
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


def test_a_cell_added_as_files_only(tmp_path, capsys):
    root = tiny.build(tmp_path, extra_per_layer=[
        {"name": "answers.tiny", "unit": "requests", "better": "higher",
         "source": "host_clock", "layer": "throwaway",
         "moves": "output_tok_s", "workloads": ["dense-serve"]}])
    (root / "perfbench" / "metrics" / "answers.tiny.py").write_text(
        EXTRA_METRIC)
    rc, line, err = _run(root, "dense-serve", capsys, trace=1)
    assert rc == 0 and line["correct"], err
    m = line["metrics"]
    assert m["answers.tiny"]["value"] > 0
    assert {"queue_wait_p95_s.serve", "book_ms.serve",
            "chunk_sync_ms.serve"} <= set(m)
    assert "output_tok_s" not in m            # an end-to-end metric
    assert list(line)[-1] == "compared"
    assert err.strip().splitlines()[-1].startswith("compared ")
    rc, line, err = _run(root, "dense-serve", capsys, trace=0)
    assert set(line["metrics"]) == {"output_tok_s", "ttft_p95_s",
                                    "tpot_p95_ms", "setup_s"}
    assert line["attempted"] == 12 and line["failed"] == 0


def _refuses(cwd, env=None):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "stablelm-serve-chat", "--seed", "1", "--seconds", "10",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=240, env=env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    return out


def test_run_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _refuses(tiny.ROOT, env)
    assert "CUDA device" in out.stderr


def test_run_refuses_with_only_the_benchmark(tmp_path):
    import shutil
    shutil.copytree(tiny.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    _refuses(tmp_path, env)

"""Tensor-parallel serving on the card: two ``gloo`` ranks on ``cuda:0``
(this process and one spawned follower) against the single-device engine.

The matrix of ``tests/test_torch_serve_mesh.py`` (sync and async decode,
prefix cache off and on, chunked prefill, block growth, a copy-on-write
fork) on the fp32 smoke config with TF32 off: tokens equal the
single-device engine's (whose chunk is a captured CUDA graph; the 2-rank
engine's runs eagerly), each rank's pool is half the single pool, no
all-reduce, and both ranks launch K1 and K2 on their heads. Under the same
2-rank group on the card: with a journal and the prefix cache, the tokens
and journal records equal the single-device engine's (fp32, exact), the
snapshot's bytes equal those of the single-device engine that computes
the ranks' column slices (``column_slice_params``), and the plain single
engine's but for the KV pages, within 1e-5 of their largest magnitude
(cuBLAS picks other fp32 kernels for a column slice's GEMM); a fresh 2-rank engine restored from the snapshot serves a known
prefix warm with the same tokens; ``chunk_sync_exc`` fails the same rows
``RowFailed`` and the later tokens are equal; and a 2-rank incarnation
killed by ``crash_at`` takes its follower down, a fresh one recovering an
uncrashed engine's tokens. They carry the ``gpu`` marker and skip without
CUDA:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_mesh_gpu.py
"""
import pytest
import torch

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.bench.serve_mesh import (MATRIX, PARITY_KW,
                                          column_slice_params,
                                          compare_snapshots, durable_case,
                                          isolation_case, journal_records,
                                          parity_matrix, parity_prompts,
                                          restore_case)
from repro_torch.kernels import ops
from repro_torch.launch import incarnation
from repro_torch.launch.mesh import ModelSpec, TPSession
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu
SPEC = ModelSpec(overrides=(("compute_dtype", "float32"),))


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K2 have no CPU mode)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = SPEC(dev)
    prompts = parity_prompts(cfg.vocab_size)
    state = Path(os.environ.get("TMPDIR", "/tmp")) / f"mesh-gpu-{os.getpid()}"
    single = durable_case(cfg, params, dev, state / "single", prompts, 8)
    sliced = durable_case(cfg, column_slice_params(cfg, params, 2), dev,
                          state / "sliced", prompts, 8)
    fault = "chunk_sync_exc:at=2"
    s_iso = isolation_case(lambda: ServeEngine(
        cfg, params, device=dev, fault_inject=fault, **PARITY_KW), prompts, 8)
    with TPSession(2, "gloo", SPEC, dev, timeout=300.0) as s:
        before = ops.launch_counts()
        res = parity_matrix(s.tp, cfg, params, prompts, 12, dev)
        after = ops.launch_counts()
        mesh = durable_case(cfg, params, dev, state / "mesh", prompts, 8,
                            tp=s.tp)
        warm = restore_case(cfg, params, dev, mesh["snapshot"], prompts[4],
                            8, tp=s.tp)
        m_iso = isolation_case(lambda: ServeEngine(
            cfg, params, device=dev, tp=s.tp, fault_inject=fault,
            **PARITY_KW), prompts, 8)
    res["durable"] = {"single": single, "sliced": sliced, "mesh": mesh,
                      "warm": warm,
                      "isolation": (s_iso, m_iso)}
    res["rank0_launches"] = {k: after[k] - before[k] for k in after}
    res["follower"] = s.followers[0]
    return res


@pytest.mark.parametrize("case", [f"async={a},prefix={p}"
                                  for a, p in MATRIX])
def test_tokens_equal_the_single_device_engine_on_the_card(mesh, case):
    run = mesh["cases"][case]
    assert run["equal"], (case, run["first_diff"])
    assert run["stats"]["prefill_windows"] > 0


def test_pool_halves_and_both_ranks_launch_the_kernels(mesh):
    full = mesh["single"]["pool_bytes"]
    assert all(r["pool_bytes"] * 2 == full for r in mesh["cases"].values())
    assert all(e["pool_bytes"] * 2 == full
               for e in mesh["follower"]["result"])
    # the matrix's engines (the follower's first; the durable scenarios
    # follow, and a warm restore may launch no K2)
    for launches in [mesh["rank0_launches"]] + [
            e["launches"]
            for e in mesh["follower"]["result"][:len(MATRIX)]]:
        assert launches["paged_attention"] > 0
        assert launches["flash_attention"] > 0
    for run in mesh["cases"].values():
        assert run["counters"]["calls"].get("all_reduce", 0) == 0


def test_durable_serving_under_the_group_equals_one_device(mesh):
    d = mesh["durable"]
    single, group = d["single"], d["mesh"]
    assert all(np.array_equal(a, b) for a, b in zip(single["outs"],
                                                    group["outs"]))
    assert journal_records(single["journal"]) == \
        journal_records(group["journal"])
    assert all(np.array_equal(a, b) for a, b in zip(d["sliced"]["outs"],
                                                    group["outs"]))
    assert compare_snapshots(d["sliced"]["snapshot"],
                             group["snapshot"])["bytes_equal"]
    vs = compare_snapshots(single["snapshot"], group["snapshot"])
    assert vs["rest_equal"]
    assert vs["pages_max_abs"] <= 1e-5 * vs["pages_max"], vs


def test_restore_under_the_group_serves_warm_on_the_card(mesh):
    d = mesh["durable"]
    assert d["warm"]["warm_hits"] > 0 and d["warm"]["warm_started"] > 0
    assert np.array_equal(d["warm"]["out"], d["single"]["outs"][4])


def test_isolation_under_the_group_on_the_card(mesh):
    (s_failed, s_later), (m_failed, m_later) = mesh["durable"]["isolation"]
    assert s_failed == m_failed == [0, 1]
    assert all(np.array_equal(a, b) for a, b in zip(s_later, m_later))


def test_crash_at_under_the_group_then_recover_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the incarnation runs on the card)")
    dev = torch.device("cuda", 0)
    cfg, params = incarnation.model(None, dev)
    with incarnation.engine(cfg, params, dev) as eng:
        oracle = [np.asarray(o).tolist() for o in eng.generate(
            incarnation.prompts(cfg.vocab_size), incarnation.MAX_NEW)]
    env = {**os.environ, "PYTHONPATH": str(
        Path(__file__).resolve().parents[1] / "src")}

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.incarnation",
             "--state-dir", str(tmp_path / "state"), "--mesh-model", "2",
             *extra], env=env, capture_output=True, text=True, timeout=300)

    crash = run("--fault-inject", "crash_at:at=3")
    assert crash.returncode == 137, crash.stderr[-3000:]
    pids = [int(p) for line in crash.stdout.splitlines()
            if line.startswith("FOLLOWERS") for p in line.split()[1]
            .split(",")]

    def gone(pid):
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
        except FileNotFoundError:
            return True

    deadline = time.monotonic() + 60.0
    while not all(map(gone, pids)) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert pids and all(map(gone, pids)), pids
    rec = run("--no-submit")
    assert rec.returncode == 0, rec.stderr[-3000:]
    replayed = {int(p[1]): [int(t) for t in p[2].split(",")]
                for p in (line.split() for line in rec.stdout.splitlines())
                if p and p[0] == "REPLAYED"}
    assert replayed
    for rid, toks in replayed.items():
        assert toks == oracle[rid], rid

"""Durability, failure isolation and the per-call baseline of the port's
tensor-parallel engine, on the CPU.

One spawned 2-rank ``gloo`` group for the module (rank 0 is this process,
the follower is spawned; rendezvous through a ``FileStore`` under the
module's temp dir), on the fp32 smoke config (KV 2: one head a rank), and
the reference engine (``repro.serve.ServeEngine``, single device, its
``gather`` oracle path) on the same weights. Every comparison is exact
(fp32 on the CPU, greedy): tokens, journal records and snapshot bytes are
held equal, not close.

* The 2-rank engine with a journal and the prefix cache serves the parity
  prompts in two waves (prompt 0 alone, then the rest, so the trie's hits
  do not depend on thread timing), drains and snapshots: its tokens,
  journal records (timestamps aside, ids relative to the run's first) and
  snapshot bytes equal the single-device engine's.
* The snapshot restores into a fresh 2-rank engine (each rank writes its
  heads: rank 0's shard holds the snapshot's first head) and a known
  prefix hits warm with the same tokens; a snapshot of the JAX engine
  restores into the 2-rank engine and a 2-rank snapshot into the JAX
  engine, each serving the JAX engine's tokens.
* ``chunk_sync_exc`` under the group (sync and async decode) fails the
  same requests ``RowFailed`` as the JAX engine under the same spec, and
  every later request's tokens equal the JAX engine's.
* The per-call baseline (``_generate_grouped``) under the group equals the
  JAX engine's.
* ``crash_at`` in a 2-rank incarnation (``repro_torch.launch.incarnation
  --mesh-model 2``, a subprocess: rank 0 dies by ``os._exit(137)``) takes
  its follower down within 60 s, and ``recover()`` in a fresh 2-rank
  incarnation on the same state directory gives an uncrashed engine's
  tokens.
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.bench.serve_mesh import (PARITY_KW, compare_snapshots,
                                          durable_case,
                                          isolation_case, journal_records,
                                          parity_prompts, serve_waves)
from repro_torch.launch import incarnation
from repro_torch.launch.mesh import ModelSpec, TPSession
from repro_torch.serve.engine import SNAPSHOT_FILE, ServeEngine
from repro_torch.serve.snapshot import read_snapshot

CPU = torch.device("cpu")
SPEC = ModelSpec(overrides=(("compute_dtype", "float32"),))
MAX_NEW = 8
FAULT = "chunk_sync_exc:at=2"
ENV = {**os.environ,
       "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src")}


def _jax_engine(params, **kw):
    """The reference engine on the port's fp32 weights."""
    jcfg = dataclasses.replace(jget_config("stablelm-1.6b").smoke(),
                               compute_dtype="float32")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    return JEngine(jcfg, jp, paged_impl="gather", **PARITY_KW, **kw)


def _durable_run(cfg, params, tp, state):
    """Journal on, prefix cache on: the waves, a drain and a snapshot."""
    run = durable_case(cfg, params, CPU, state,
                       parity_prompts(cfg.vocab_size), MAX_NEW, tp=tp)
    return dict(run, state=state, bytes=run["snapshot_bytes"])


def _isolation(run_engine):
    """Two requests seated when the fault fires (both fail), then the
    other prompts after the reset: ``(failed indices, later tokens)``."""
    return isolation_case(run_engine,
                          parity_prompts(SPEC.config().vocab_size), MAX_NEW)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The reference engine: the waves with the prefix cache, drained and
    snapshotted; the per-call baseline; the isolation scenario."""
    cfg, params = SPEC(CPU)
    prompts = parity_prompts(cfg.vocab_size)
    state = tmp_path_factory.mktemp("jax-state")
    with _jax_engine(params, prefix_cache=True) as eng:
        outs = serve_waves(eng, prompts, MAX_NEW)
        assert eng.drain()
        eng.snapshot(str(state / SNAPSHOT_FILE))
        per_call = [np.asarray(o)
                    for o in eng._generate_grouped(prompts, MAX_NEW)]
    iso = _isolation(lambda: _jax_engine(params, fault_inject=FAULT))
    return {"outs": outs, "snap": str(state / SNAPSHOT_FILE),
            "per_call": per_call, "isolation": iso}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    store = tmp_path_factory.mktemp("tp") / "store"
    with TPSession(2, "gloo", SPEC, CPU, init_method=f"file://{store}",
                   timeout=120.0) as s:
        yield s


@pytest.fixture(scope="module")
def durable(group, tmp_path_factory):
    cfg, params = SPEC(CPU)
    return {"single": _durable_run(cfg, params, None,
                                   tmp_path_factory.mktemp("single")),
            "mesh": _durable_run(cfg, params, group.tp,
                                 tmp_path_factory.mktemp("mesh"))}


def test_group_tokens_equal_the_single_and_jax_engines(durable, jax_side):
    for a, b, c in zip(durable["single"]["outs"], durable["mesh"]["outs"],
                       jax_side["outs"]):
        assert a.tolist() == b.tolist() == c.tolist()


def test_group_journal_records_equal_the_single_engine(durable):
    want = journal_records(durable["single"]["journal"])
    got = journal_records(durable["mesh"]["journal"])
    assert got == want
    kinds = {r["k"] for rs in got.values() for r in rs}
    assert {"submit", "admit", "first_token", "finish"} <= kinds, kinds
    assert len(got) == 6


def test_group_snapshot_bytes_equal_the_single_engine(durable):
    single, mesh = durable["single"], durable["mesh"]
    a = (single["state"] / SNAPSHOT_FILE).read_bytes()
    b = (mesh["state"] / SNAPSHOT_FILE).read_bytes()
    assert mesh["bytes"] == len(b) and a == b
    assert compare_snapshots(single["snapshot"], mesh["snapshot"]) == {
        "bytes_equal": True, "rest_equal": True, "pages_max_abs": 0.0,
        "pages_max": pytest.approx(float(np.abs(np.ascontiguousarray(
            read_snapshot(mesh["snapshot"])[1]["prefix_pages"]).view(
                np.float32)).max()))}
    meta, arrays = read_snapshot(str(mesh["state"] / SNAPSHOT_FILE))
    assert meta["prefix"] and arrays["prefix_pages"].shape[3] == 2


def test_group_snapshot_restores_warm_in_a_fresh_group_engine(durable,
                                                              group):
    cfg, params = SPEC(CPU)
    path = str(durable["mesh"]["state"] / SNAPSHOT_FILE)
    meta, arrays = read_snapshot(path)
    prompts = parity_prompts(cfg.vocab_size)
    with ServeEngine(cfg, params, tp=group.tp, device=CPU, prefix_cache=True,
                     **PARITY_KW) as eng:
        ptr = eng._pkv.data_ptr()
        assert eng.restore(path) == []
        assert eng.stats["warm_started"] == len(meta["prefix"])
        assert eng._pkv.data_ptr() == ptr
        pages = torch.from_numpy(arrays["prefix_pages"]).view(torch.float32)
        for i, n in enumerate(eng._prefix.export_nodes()):
            j = [e["key"] for e in meta["prefix"]].index(n["key"])
            assert torch.equal(eng._pkv[:, :, n["block"]],
                               pages[:, :, j, :1]), n["key"]
        out = eng.result(eng.submit(prompts[4], MAX_NEW))
        assert eng._prefix.stats["warm_hits"] > 0
    assert out.tolist() == durable["single"]["outs"][4].tolist()


def test_jax_snapshot_restores_into_the_group_engine(jax_side, group):
    cfg, params = SPEC(CPU)
    prompts = parity_prompts(cfg.vocab_size)
    with ServeEngine(cfg, params, tp=group.tp, device=CPU, prefix_cache=True,
                     **PARITY_KW) as eng:
        eng.restore(jax_side["snap"])
        assert eng.stats["warm_started"] > 0
        out = eng.result(eng.submit(prompts[0], MAX_NEW))
        assert eng._prefix.stats["warm_hits"] > 0
    assert out.tolist() == jax_side["outs"][0].tolist()


def test_group_snapshot_restores_into_the_jax_engine(durable, jax_side):
    _, params = SPEC(CPU)
    prompts = parity_prompts(SPEC.config().vocab_size)
    with _jax_engine(params, prefix_cache=True) as jeng:
        jeng.restore(str(durable["mesh"]["state"] / SNAPSHOT_FILE))
        assert jeng.stats["warm_started"] > 0
        out = jeng.result(jeng.submit(prompts[5], MAX_NEW))
        assert jeng._prefix.stats["warm_hits"] > 0
    assert np.asarray(out).tolist() == jax_side["outs"][5].tolist()


@pytest.mark.parametrize("async_decode", [False, True],
                         ids=["sync", "async"])
def test_chunk_sync_exc_isolation_matches_the_jax_engine(jax_side, group,
                                                         async_decode):
    cfg, params = SPEC(CPU)
    failed, later = _isolation(lambda: ServeEngine(
        cfg, params, tp=group.tp, device=CPU, fault_inject=FAULT,
        async_decode=async_decode, **PARITY_KW))
    want_failed, want_later = jax_side["isolation"]
    assert failed == want_failed == [0, 1]
    assert [o.tolist() for o in later] == [o.tolist() for o in want_later]


def test_per_call_baseline_under_the_group_equals_the_jax_engine(jax_side,
                                                                 group):
    cfg, params = SPEC(CPU)
    prompts = parity_prompts(cfg.vocab_size)
    group.tp.reset_counters()
    with ServeEngine(cfg, params, tp=group.tp, device=CPU,
                     **PARITY_KW) as eng:
        got = eng._generate_grouped(prompts, MAX_NEW)
        assert eng._contig == {}           # every group's cache dropped
    for a, b in zip(got, jax_side["per_call"]):
        assert np.asarray(a).tolist() == b.tolist()
    calls = group.tp.counters()["calls"]
    assert calls["all_gather:contig_prefill"] > 0
    assert calls["all_gather:contig_decode"] > 0


# ---------------------------------------------- crash_at under a group
def _incarnation(state, *extra):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.incarnation",
         "--state-dir", str(state), "--device", "cpu", "--mesh-model", "2",
         *extra], env=ENV, capture_output=True, text=True, timeout=300.0)


def _lines(stdout, tag):
    return {int(p[1]): [int(t) for t in p[2].split(",")]
            for p in (line.split() for line in stdout.splitlines())
            if p and p[0] == tag}


def _gone(pid):
    """The process has exited (or is a zombie nobody reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except FileNotFoundError:
        return True


def test_crash_at_under_a_group_then_recover_in_a_fresh_group(tmp_path):
    cfg, params = incarnation.model(None, CPU)
    with incarnation.engine(cfg, params, CPU) as eng:
        oracle = {i: np.asarray(o).tolist() for i, o in enumerate(
            eng.generate(incarnation.prompts(cfg.vocab_size),
                         incarnation.MAX_NEW))}
    state = tmp_path / "state"
    crash = _incarnation(state, "--fault-inject", "crash_at:at=3")
    assert crash.returncode == 137, crash.stderr[-3000:]
    (pid,) = [int(p) for line in crash.stdout.splitlines()
              if line.startswith("FOLLOWERS")
              for p in line.split()[1].split(",")]
    deadline = time.monotonic() + 60.0
    while not _gone(pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert _gone(pid), f"follower {pid} outlived its rank 0 by 60 s"
    rec = _incarnation(state, "--no-submit")
    assert rec.returncode == 0, rec.stderr[-3000:]
    assert rec.stdout.strip().splitlines()[-1] == "EXIT CLEAN"
    done, replayed = _lines(crash.stdout, "DONE"), _lines(rec.stdout,
                                                          "REPLAYED")
    assert replayed and not set(done) & set(replayed)
    for rid, want in oracle.items():
        assert (done.get(rid) or replayed.get(rid)) == want, rid

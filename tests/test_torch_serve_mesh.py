"""Tensor-parallel serving on the port (the counterpart of
``tests/test_serve_mesh.py``), on the CPU.

* The serving gates and the typed refusal against the reference's
  (``repro.distributed.sharding``), the ``REPRO_MESH_MODEL`` clamp and the
  shard layout, in-process; a group refuses only a captured chunk
  (``TPUnsupported``) and a rank other than 0, and a journal and a benign
  fault-injection spec serve the single-device tokens under it.
* One spawned 2-rank ``gloo`` group for the module (rank 0 is this
  process, the follower is spawned; rendezvous through a ``FileStore``
  under the module's temp dir), on the fp32 smoke config (KV 2: one head
  a rank): the single-device engine and the 2-rank engine on the
  reference test's prompts in sync and async decode with the prefix
  cache off and on (chunked prefill, block growth, prefix hits and a
  copy-on-write fork happen), tokens equal; each rank's pool is half the
  single-device pool; the collective counters show no all-reduce and no
  decode-chunk all-gather reaching half a pool shard (the reference's
  HLO check); the prefill logits of both ranks against the single-device
  model. Every join has a timeout: a hung or failed follower fails the
  module with its traceback.
* The reference engine (``repro.serve.ServeEngine``, single device, on
  its ``gather`` oracle path as ``tests/test_torch_serve.py`` runs it) on
  the same fp32 weights and prompts: every 2-rank case's tokens, and the
  single-device port engine's, equal its tokens exactly (the reference's
  own mesh test holds its mesh tokens to this engine).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.bench.serve_mesh import (MATRIX, PARITY_KW,
                                          ProbeThenFollow, parity_matrix,
                                          parity_prompts, probe_logits,
                                          run_case)
from repro_torch.configs import get_config
from repro_torch.distributed import (MeshDivisibilityError, TPGroup,
                                     serve_attn_sharded, serve_mlp_sharded,
                                     shard_serve_params, validate_serve_mesh)
from repro_torch.launch.mesh import ModelSpec, TPSession, env_mesh_model
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import TPUnsupported

CPU = torch.device("cpu")
SPEC = ModelSpec(overrides=(("compute_dtype", "float32"),))
MAX_NEW = 12


def _smoke():
    return get_config("stablelm-1.6b").smoke()


# ------------------------------------------------------------- in-process
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b",
                                  "falcon-mamba-7b", "zamba2-1.2b"])
@pytest.mark.parametrize("mp", [1, 2, 3, 4, 64])
def test_gates_match_the_reference(arch, mp):
    cfg, jcfg = get_config(arch).smoke(), jget_config(arch).smoke()
    assert serve_attn_sharded(cfg, mp) == jsharding.serve_attn_sharded(
        jcfg, mp)
    assert serve_mlp_sharded(cfg, mp) == jsharding.serve_mlp_sharded(
        jcfg, mp)


def test_validate_serve_mesh_typed_error_as_the_reference():
    cfg = _smoke()
    validate_serve_mesh(cfg, 1)
    validate_serve_mesh(cfg, 2)
    with pytest.raises(MeshDivisibilityError) as ei:
        validate_serve_mesh(cfg, 4)
    with pytest.raises(jsharding.MeshDivisibilityError) as ej:
        jsharding.validate_serve_mesh(jget_config("stablelm-1.6b").smoke(),
                                      4)
    assert str(ei.value) == str(ej.value)
    assert "num_kv_heads=2" in str(ei.value)
    assert isinstance(ei.value, ValueError)
    validate_serve_mesh(dataclasses.replace(cfg, ssm=True), 4)


def test_four_ranks_on_the_smoke_config_raise():
    """An explicit indivisible group is refused typed, before any
    collective (the group here has no process group behind it)."""
    cfg, params = SPEC(CPU)
    with pytest.raises(MeshDivisibilityError, match="num_kv_heads=2"):
        ServeEngine(cfg, params, tp=TPGroup(0, 4, CPU), device=CPU)


@pytest.mark.parametrize("env,arch,available,want", [
    ("", "stablelm-1.6b", None, 1),
    ("4", "stablelm-1.6b", None, 2),        # KV=2: 4 clamps to 2
    ("2", "stablelm-1.6b", None, 2),
    ("4", "stablelm-1.6b", 1, 1),           # one GPU under nccl
    ("3", "qwen2-moe-a2.7b", None, 2),
    ("4", "falcon-mamba-7b", None, 1),      # SSM: nothing to shard
    ("4", "zamba2-1.2b", None, 1),
])
def test_env_mesh_model_clamps_as_the_reference(monkeypatch, env, arch,
                                                available, want):
    monkeypatch.setenv("REPRO_MESH_MODEL", env)
    assert env_mesh_model(get_config(arch).smoke(), available) == want


def test_shards_cut_the_reference_leaves_on_their_last_dim():
    for arch in ("stablelm-1.6b", "qwen2-moe-a2.7b"):
        cfg, params = ModelSpec(arch)(CPU)
        shards = [shard_serve_params(cfg, params, r, 2) for r in range(2)]
        for name, full in params["blocks"].items():
            cut = name in jsharding._SERVE_ATTN_LEAVES or (
                name in jsharding._SERVE_MLP_LEAVES
                and serve_mlp_sharded(cfg, 2))
            got = [s["blocks"][name] for s in shards]
            if cut:
                assert got[0].shape[-1] * 2 == full.shape[-1], name
                assert torch.equal(torch.cat(got, dim=-1), full), name
            else:
                assert all(g is full for g in got), name
        for name in ("embed", "final_norm", "lm_head"):
            if name in params:
                assert shards[1][name] is params[name]


@pytest.mark.parametrize("mode", ["journal", "fault_inject", "chunk_graph"])
def test_what_a_group_refuses(mesh, mode):
    """Only a captured chunk is refused under a group (typed, before any
    collective: this group has no process group behind it), as is a rank
    other than 0. A journal and a benign fault-injection spec (refused
    until the group carried them) serve the single-device engine's tokens
    on the module's 2-rank group, the journal holding every request."""
    cfg, params = SPEC(CPU)
    if mode == "chunk_graph":
        with pytest.raises(TPUnsupported, match="chunk_graph=True"):
            ServeEngine(cfg, params, tp=TPGroup(0, 2, CPU), device=CPU,
                        chunk_graph=True)
        with pytest.raises(ValueError, match="rank 0"):
            ServeEngine(cfg, params, tp=TPGroup(1, 2, CPU), device=CPU)
        return
    run = mesh["modes"][mode]
    for got, want in zip(run["outs"], mesh["single"]["outs"]):
        assert np.array_equal(got, want), mode
    if mode == "journal":
        blob = open(run["journal"], "rb").read()
        assert blob.count(b'"k":"submit"') == blob.count(b'"k":"finish"') \
            == len(run["outs"]) == 6


def test_ssm_serves_on_rank_zero_with_the_followers_idle(tmp_path):
    """SSM archs do not shard: the engine serves alone (no collective;
    this group has no process group behind it) with the single engine's
    tokens, and its snapshot and per-call baseline (refused until the
    group carried them) are the single engine's: the same snapshot bytes
    and the same per-call tokens."""
    cfg = dataclasses.replace(get_config("falcon-mamba-7b").smoke(),
                              compute_dtype="float32")
    _, params = ModelSpec("falcon-mamba-7b",
                          overrides=(("compute_dtype", "float32"),))(CPU)
    prompts = parity_prompts(cfg.vocab_size)[:3]
    runs = []
    for tag, tp in (("single", None), ("group", TPGroup(0, 2, CPU))):
        with ServeEngine(cfg, params, device=CPU, max_batch=2,
                         tp=tp) as eng:
            outs = eng.generate(prompts, max_new=6)
            assert eng.drain()
            eng.snapshot(str(tmp_path / f"{tag}.snap"))
            per_call = eng._generate_grouped(prompts, 4)
        runs.append((outs, (tmp_path / f"{tag}.snap").read_bytes(),
                     per_call))
    (want, snap, pc), (got, gsnap, gpc) = runs
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    assert gsnap == snap
    assert all(np.array_equal(a, b) for a, b in zip(pc, gpc))


# ------------------------------------------------- one 2-rank gloo group
def _jax_tokens(params, prompts):
    """The reference engine's tokens on the port's weights (the same fp32
    leaves, name for name)."""
    jcfg = dataclasses.replace(jget_config("stablelm-1.6b").smoke(),
                               compute_dtype="float32")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), params)
    with JEngine(jcfg, jp, paged_impl="gather", **PARITY_KW) as eng:
        return eng.generate(list(prompts), max_new=MAX_NEW)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    cfg, params = SPEC(CPU)
    prompts = parity_prompts(cfg.vocab_size)
    jax_outs = _jax_tokens(params, prompts)
    probe = np.stack([prompts[0][:16], prompts[3][:16]])
    store = tmp_path_factory.mktemp("tp") / "store"
    with TPSession(2, "gloo", SPEC, CPU, init_method=f"file://{store}",
                   body=ProbeThenFollow(tuple(map(tuple, probe.tolist()))),
                   timeout=120.0) as s:
        got = probe_logits(cfg, params, s.tp, torch.from_numpy(probe))
        want, _ = lm.prefill(cfg, params, torch.from_numpy(probe))
        res = parity_matrix(s.tp, cfg, params, prompts, MAX_NEW, CPU)
        journal = str(tmp_path_factory.mktemp("journal") / "j.wal")
        res["modes"] = {
            "journal": dict(run_case(cfg, params, prompts, MAX_NEW, CPU,
                                     tp=s.tp, journal=journal, **PARITY_KW),
                            journal=journal),
            "fault_inject": run_case(
                cfg, params, prompts, MAX_NEW, CPU, tp=s.tp,
                fault_inject="alloc_fail:p=0.1,seed=1", **PARITY_KW)}
    res["logits"] = (got, want)
    res["followers"] = s.followers
    res["jax"] = jax_outs
    return res


@pytest.mark.parametrize("case", [f"async={a},prefix={p}"
                                  for a, p in MATRIX])
def test_tokens_equal_the_single_device_engine(mesh, case):
    run = mesh["cases"][case]
    assert run["equal"], (case, run["first_diff"])
    st = run["stats"]
    assert st["grown_blocks"] > 0 and st["prefill_windows"] > 0, st
    if "prefix=True" in case:
        assert st["prefix_hits"] > 0 and st["cow_forks"] > 0, st


@pytest.mark.parametrize("case", ["single"] + [f"async={a},prefix={p}"
                                               for a, p in MATRIX])
def test_tokens_equal_the_jax_engine(mesh, case):
    run = mesh["single"] if case == "single" else mesh["cases"][case]
    for i, (got, want) in enumerate(zip(run["outs"], mesh["jax"])):
        assert np.asarray(got).tolist() == np.asarray(want).tolist(), \
            (case, i)
    assert len(run["outs"]) == len(mesh["jax"]) == 6


def test_single_device_run_exercises_the_paths(mesh):
    st = mesh["single"]["stats"]
    assert st["grown_blocks"] > 0 and st["prefill_windows"] > 0, st
    assert [len(o) for o in mesh["single"]["outs"]] == [MAX_NEW] * 6


def test_each_rank_holds_half_the_pool(mesh):
    full = mesh["single"]["pool_bytes"]
    for run in mesh["cases"].values():
        assert run["pool_bytes"] * 2 == full
    (follower,) = mesh["followers"]
    engines = follower["result"]
    assert len(engines) == len(MATRIX) + len(mesh["modes"])
    assert all(e["pool_bytes"] * 2 == full for e in engines)


def test_collectives_are_all_gathers_below_half_a_pool_shard(mesh):
    """The stand-in for the reference's HLO check: no all-reduce, and no
    all-gather of the decode chunk reaches half the rank's pool shard (the
    pool is never reassembled)."""
    for case, run in mesh["cases"].items():
        c = run["counters"]
        assert c["calls"].get("all_reduce", 0) == 0, (case, c)
        assert c["calls"].get("all_gather:chunk", 0) > 0, (case, c)
        assert c["max_bytes"]["all_gather:chunk"] * 2 < run["pool_bytes"], \
            (case, c)
    fc = mesh["followers"][0]["counters"]
    assert fc["calls"].get("all_reduce", 0) == 0
    assert fc["calls"]["all_gather"] > 0


def test_prefill_logits_of_the_ranks(mesh):
    """Each rank's products are column slices of the single-device ones
    and the shards are concatenated, not summed: on the CPU in fp32 the
    2-rank logits are bit-identical to the single-device model's (largest
    difference 0.0)."""
    got, want = mesh["logits"]
    assert torch.equal(got, want), float((got - want).abs().max())


def test_serve_mesh_suite_carries_the_reference_rows(tmp_path):
    """``bench.run --only serve_mesh --quick --device cpu --mesh-model 2``
    writes every row name of the reference's ``bench_mesh``
    (``benchmarks/serve_continuous.py``) and asserts its own parity."""
    import json
    import re
    from pathlib import Path

    from repro_torch.bench import run as trun
    src = (Path(__file__).resolve().parents[1] / "benchmarks"
           / "serve_continuous.py").read_text()
    ref = set(re.findall(r'yield \("(serve_mesh_[a-z0-9_]+)"', src))
    assert len(ref) == 10, ref
    assert trun.main(["--device", "cpu", "--only", "serve_mesh", "--quick",
                      "--mesh-model", "2", "--bench-dir",
                      str(tmp_path)]) == 0
    rows = {r["name"]: r for r in json.loads(
        (tmp_path / "BENCH_serve_mesh.json").read_text())["rows"]}
    assert ref <= set(rows), ref - set(rows)
    assert rows["serve_mesh_parity"]["value"] == "exact"
    assert rows["serve_mesh_all_reduces"]["value"] == "0"


def test_nccl_needs_a_gpu_a_rank_and_is_never_swapped_for_gloo():
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(RuntimeError, match="nccl tensor parallelism"):
        launch_serve.main(["--device", "cpu", "--mesh-model", "2",
                           "--tp-backend", "nccl"])


def test_a_failed_follower_fails_the_session_with_its_traceback(tmp_path):
    """A follower whose work raises (here ``int(cfg, params, tp)``, a
    TypeError) is reported by rank 0 with its traceback, within the
    join's timeout: nothing is swallowed."""
    with pytest.raises(RuntimeError, match="TypeError"):
        with TPSession(2, "gloo", SPEC, CPU, body=int, timeout=60.0,
                       init_method=f"file://{tmp_path / 'store'}"):
            pass

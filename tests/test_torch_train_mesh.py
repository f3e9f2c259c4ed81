"""Sharded training on the port (the counterpart of the mesh parts of
``repro.train`` and of ``tests/test_sharding_and_mesh.py`` /
``tests/test_checkpoint.py``'s elastic restore), on the CPU.

* The rule table (``param_shardings``) against the reference's, leaf for
  leaf, for every registered arch's smoke config on meshes (1, 1), (2, 1),
  (2, 2), (4, 1) and (3, 2) (where 3 divides no width: the divisibility
  guard drops the axis), in-process: the reference's ``_rule`` reads only
  ``ctx.mesh.shape``, so a stand-in mesh with that mapping serves, and its
  ``NamedSharding`` wrapper is patched out to leave the specs.
* One spawned ``gloo`` group of 4 CPU ranks for the module (rank 0 is this
  process; every collective has a 60 s timeout and the join 300 s; what
  the ranks run is in ``tests/test_torch_train_mesh_ranks.py``), on the
  fp32 stablelm-1.6b smoke config with the reference's PRNGKey(0) weights:
  the sharded step on meshes (2, 1), (4, 1) and (2, 2), with the weight
  gather hoisted and not, ``microbatches`` None, 1 and 2 and compression,
  against the reference's sharded step (one subprocess with 4 virtual
  devices, ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, started
  first and run beside the group) and against the port's single-device
  step; each rank's state bytes against its specs; a checkpoint saved at
  1 rank restored at 2 and 4, saved there (the same bytes, read by the
  reference's ``CheckpointManager``), restored across, and back at 1; and
  ``Trainer(ctx=)`` on 2 ranks, uninterrupted and restarted from its
  checkpoint after ``fail_at_step``.

Tolerances (``tests/test_torch_train_step.py``'s): loss, metrics and the
moments within 1e-5 relative to each leaf's largest magnitude; the new
params within 5e-2 x lr absolute. Measured against the reference's
sharded step without hoisting: metrics 8.0e-8 relative, moments 7.3e-7,
params 3.6e-3 x lr. With the gather hoisted the gradients are bf16 (the
gathered weights are, in both frameworks), and the two frameworks round
the per-layer cotangents to bf16 at other places: there the moments are
held within 2e-2 of each leaf's largest magnitude (measured 7.8e-3, one
bf16 ulp) and the params within 2.05 x lr, the most a first AdamW step can
move a weight apart (lr x (1 + 1) where a near-zero gradient's sign flips;
measured 1.96 x lr; the metrics stay within 1e-5). Against the port's
single-device step the unhoisted cases are held to the first set; the
hoisted ones differ by the bf16 weights (measured: loss 1.8e-5 and grad
norm 1.3e-4 relative), held within 1e-4 and 5e-4.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.registry import ARCHS as JARCHS
from repro.distributed.sharding import ShardCtx as JShardCtx
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.train import train_step as jtrain_step
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.distributed.op_analysis import (DryMeshGroup, StepCost,
                                                 analyze_step)
from repro_torch.distributed.sharding import Mesh, NamedSharding
from repro_torch.launch.mesh import MeshSession, make_ctx, small_mesh
from repro_torch.optim import init_error_state, init_opt_state
from repro_torch.params import from_reference
from repro_torch.train import CheckpointManager
from repro_torch.train.train_step import (batch_shardings, make_train_step,
                                          opt_shardings, param_shapes,
                                          param_shardings, train_input_specs)
from repro_torch.tree import leaves
from test_torch_train_mesh_ranks import (ARCH, B, CASES, CPU, LR, S,
                                         TRAIN_TC, Body, case_id, cfg_of,
                                         fail_on_rank_one, fail_then_reduce,
                                         full_state, opt_of, tokens,
                                         trainer_run)

STEP_REL, PARAM_STEP_LR = 1e-5, 5e-2
HOIST_MOMENT_REL, ILL_LR = 2e-2, 2.05
QUANTUM_REL = 1.01 / 127
HOIST_METRIC_REL = 5e-5
HOIST_SINGLE = {"loss": 1e-4, "grad_norm": 5e-4}
MESHES = [(1, 1), (2, 1), (2, 2), (4, 1), (3, 2)]

ROOT = Path(__file__).resolve().parents[1]
# ------------------------------------------------------- the rule table
def _standin(d, m):
    return types.SimpleNamespace(shape={"data": d, "model": m},
                                 axis_names=("data", "model"))


def _ref_specs(monkeypatch, arch, d, m):
    monkeypatch.setattr(jtrain_step, "_ns", lambda ctx, spec: spec)
    ctx = jmesh.make_ctx(_standin(d, m))
    return jtrain_step.param_shardings(jget_config(arch).smoke(), ctx)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_rule_table_equals_the_reference(monkeypatch, arch, mesh):
    ref = _ref_specs(monkeypatch, arch, *mesh)
    got = param_shardings(get_config(arch).smoke(),
                          make_ctx(small_mesh(*mesh)))
    ref_flat = {k: tuple(v) for k, v in _flat(ref)}
    got_flat = {k: v.spec for k, v in _flat(got)}
    assert got_flat == ref_flat


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "internvl2-1b"])
def test_batch_and_optimizer_shardings_as_the_reference(monkeypatch, arch):
    monkeypatch.setattr(jtrain_step, "_ns", lambda ctx, spec: spec)
    jctx = jmesh.make_ctx(_standin(2, 2))
    ctx = make_ctx(small_mesh(2, 2))
    ref = jtrain_step.batch_shardings(jget_config(arch).smoke(), jctx)
    got = batch_shardings(get_config(arch).smoke(), ctx)
    assert {k: v.spec for k, v in got.items()} == \
        {k: tuple(v) for k, v in ref.items()}
    pshard = param_shardings(get_config(arch).smoke(), ctx)
    opt = opt_shardings(get_config(arch).smoke(), ctx, pshard)
    assert opt["m"] is pshard and opt["v"] is pshard
    assert opt["count"].spec == ()


def test_rule_table_drops_an_axis_that_does_not_divide(monkeypatch):
    """The guard: on a (3, 2) mesh, 3 divides none of the smoke widths, so
    no leaf is sharded over ``data``, while ``model`` (2) stays where it
    divides."""
    got = param_shardings(get_config(ARCH).smoke(),
                          make_ctx(small_mesh(3, 2)))
    specs = [v.spec for _, v in _flat(got)]
    assert not any("data" in s for s in specs)
    assert any("model" in s for s in specs)
    assert got["embed"].spec == ("model", None)


def test_param_specs_rules_stacked_blocks_as_the_reference():
    """``tests/test_sharding_and_mesh.py::test_param_specs_rules``: without
    a mesh every leaf is unsharded, stacked leaves carry the layer dim."""
    cfg = get_config("qwen3-14b").smoke()
    from repro_torch.distributed import ShardCtx, param_specs
    specs = param_specs(param_shapes(cfg), ShardCtx(mesh=None))
    assert specs["blocks"]["wq"] == (None, None, None)
    assert specs["embed"] == (None, None)
    assert param_shardings(cfg, ShardCtx(mesh=None))["embed"] is None


def test_divisibility_of_the_padded_vocab():
    """``tests/test_sharding_and_mesh.py::test_divisibility_guard_drops_
    axis``'s premise: the odd smoke vocabulary is padded to a multiple of
    256, so the embedding shards on any power-of-two mesh."""
    cfg = get_config(ARCH).smoke()
    assert cfg.vocab_size == 503 and cfg.padded_vocab % 256 == 0
    got = param_shardings(cfg, make_ctx(small_mesh(4, 2)))
    assert got["embed"].spec == ("model", "data")


@pytest.mark.parametrize("names", [("data", "model"),
                                   ("pod", "data", "model"), ("data",),
                                   ("model",)])
def test_make_ctx_as_the_reference(names):
    sizes = (2,) * len(names)
    ref = jmesh.make_ctx(types.SimpleNamespace(
        shape=dict(zip(names, sizes)), axis_names=names))
    got = make_ctx(Mesh(sizes, names))
    for f in ("dp", "fsdp", "tp", "sp"):
        assert getattr(got, f) == getattr(ref, f), f
    for logical in ("dp", "fsdp", "tp", "sp"):
        try:
            want = ref.axis_size(logical)
        except KeyError:     # dp names "data", which a model-only mesh lacks
            with pytest.raises(KeyError):
                got.axis_size(logical)
            continue
        assert got.axis_size(logical) == want
    assert make_ctx(None).mesh is None and JShardCtx(mesh=None).dp == \
        make_ctx(None).dp


@pytest.mark.parametrize("spec", [("data", "model"), ("model", "data"),
                                  (None, "data"), (("data", "model"), None),
                                  (None, None), ("model", None)])
def test_named_sharding_blocks_reassemble(spec):
    mesh = small_mesh(2, 2)
    t = torch.arange(8 * 12).reshape(8, 12)
    ns = NamedSharding(mesh, spec)
    blocks = [ns.shard(t, r) for r in range(4)]
    assert torch.equal(ns.assemble(blocks), t)
    holders = [r for r in range(4) if ns.holds_first(r)]
    n_axes = len({a for e in spec if e for a in
                  (e if isinstance(e, tuple) else (e,))})
    assert len(holders) == (4 if n_axes == 2 else 2 if n_axes else 1)
    assert ns.nbytes(t.shape, t.dtype) == blocks[0].numel() * 8


def test_mesh_coordinates_are_row_major():
    mesh = Mesh((2, 3), ("data", "model"))
    assert [mesh.coords(r) for r in (0, 4)] == [
        {"data": 0, "model": 0}, {"data": 1, "model": 1}]
    assert mesh.axis_ranks(("data",), 4) == [1, 4]
    assert mesh.axis_groups(("model",)) == [[0, 1, 2], [3, 4, 5]]
    assert mesh.axis_index(("data", "model"), 5) == 5


def test_a_mesh_of_one_needs_no_group():
    """On a (1, 1) mesh the sharded step runs without a process group; on
    a larger one without its MeshGroup it refuses."""
    make_train_step(cfg_of(), opt_of(), ctx=make_ctx(small_mesh(1, 1)))
    with pytest.raises(ValueError, match="MeshGroup"):
        make_train_step(cfg_of(), opt_of(), ctx=make_ctx(small_mesh(2, 1)))


# ------------------------------------------------- the reference's step
REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_ctx, small_mesh
from repro.models import lm
from repro.optim.adamw import OptConfig, init_opt_state
from repro.optim.compress import init_error_state
from repro.train.train_step import batch_shardings, make_train_step

cases, out_dir, lr, B, S = json.loads(sys.argv[1])
toks = np.random.default_rng(1).integers(0, 503, (B, S)).astype(np.int32)
opt = OptConfig(lr=lr, warmup_steps=0, total_steps=10)
for name, (d, m), hoist, mb, comp in cases:
    cfg = dataclasses.replace(get_config("stablelm-1.6b").smoke(),
                              compute_dtype="float32",
                              hoist_weight_gather=hoist)
    mesh = small_mesh(d, m)
    ctx = make_ctx(mesh)
    step, _, (pshard, oshard) = make_train_step(cfg, ctx, opt,
                                                compress=comp,
                                                microbatches=mb)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    st = init_opt_state(params, opt)
    if comp:
        st["err"] = init_error_state(params)
        oshard = dict(oshard, err=pshard)
    params = jax.device_put(params, pshard)
    st = jax.device_put(st, oshard)
    batch = jax.device_put({"tokens": jnp.asarray(toks)},
                           batch_shardings(cfg, ctx))
    with mesh:
        p2, o2, met = jax.jit(step)(params, st, batch)
    out = {f"metric/{k}": np.asarray(v) for k, v in met.items()}
    for what, tree in (("params", p2), ("m", o2["m"]), ("v", o2["v"])):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            out[what + jax.tree_util.keystr(path)] = np.asarray(leaf)
    np.savez(f"{out_dir}/{name}.npz", **out)
print("ref done", flush=True)
"""


def _start_reference(out_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=str(ROOT / "src"))
    arg = json.dumps([[[case_id(c), list(c[0]), c[1], c[2], c[3]]
                       for c in CASES],
                      str(out_dir), LR, B, S])
    # at a lower priority, as the spawned ranks: the module's helper
    # processes yield the CPU to the other workers' timing-bound tests
    return subprocess.Popen(["nice", "-n", "10", sys.executable, "-c",
                             REF_SCRIPT, arg],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# -------------------------------------------------------- the fixture
def _ref_tree():
    cfg = jget_config(ARCH).smoke()
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        dataclasses.replace(cfg, compute_dtype="float32"),
        jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_mesh")
    (root / "ref").mkdir()
    ref_proc = _start_reference(root / "ref")
    try:
        tree = _ref_tree()
        toks = tokens()
        # the 1-rank checkpoint the elastic restores start from
        whole = full_state(cfg_of(), tree)
        CheckpointManager(str(root / "ckpt1")).save(5, whole)
        (root / "whole.json").write_text(json.dumps({"step": 5}))
        with MeshSession(4, "gloo", Body(tree, toks, str(root)), CPU,
                         init_method=f"file://{root / 'store'}",
                         timeout=300.0, op_timeout_s=60.0) as s:
            s.run()
        res = {"ranks": s.results, "tree": tree, "toks": toks,
               "root": root, "whole": whole}
        out, err = ref_proc.communicate(timeout=600)
        assert ref_proc.returncode == 0, err[-3000:]
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    res["ref"] = {case_id(c): dict(np.load(root / "ref"
                                           / f"{case_id(c)}.npz"))
                  for c in CASES}
    return res


def _single_step(tree, toks, mb, compress):
    cfg = cfg_of()
    params = from_reference(tree, cfg, device=CPU, cast=False)
    st = init_opt_state(params, opt_of())
    if compress:
        st["err"] = init_error_state(params)
    p, o, m = make_train_step(cfg, opt_of(), compress=compress,
                              microbatches=mb)(
        params, st, {"tokens": torch.from_numpy(toks)})
    return ({k: float(v) for k, v in m.items()},
            {"params": [x.numpy() for x in leaves(p)],
             "m": [x.numpy() for x in leaves(o["m"])],
             "v": [x.numpy() for x in leaves(o["v"])]})


def _ref_leaves(ref, what):
    keys = sorted((k for k in ref if k.startswith(what + "[")),
                  key=lambda k: k)
    return keys, [ref[k] for k in keys]


def _rel_err(a, b):
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    return err / max(scale, 1e-30)


def _hold(got_m, got, want_m, want, what, moment_rel=STEP_REL,
          quantised=False, metric_rel=STEP_REL, param_lr=PARAM_STEP_LR):
    """``got`` against ``want`` (metrics and the new params and moments,
    leaf by leaf). The params are held within PARAM_STEP_LR x lr where the
    step is well-conditioned, and within ILL_LR x lr (a first AdamW step
    moves a weight by lr x (g / (|g| + eps) + decay), so two steps differ
    by at most 2 lr) where it is not: where the wanted first moment shows
    a gradient within 100 eps of zero, or, under compression, a gradient
    quantised to one int8 step of its tensor's amax or less (one step
    apart across zero is a whole lr). Returns what was measured."""
    seen = {"metric": 0.0, "m": 0.0, "v": 0.0, "param_lr": 0.0,
            "ill_param_lr": 0.0, "ill": 0}
    for k in want_m:
        rel = abs(got_m[k] - want_m[k]) / max(abs(want_m[k]), 1e-30)
        seen["metric"] = max(seen["metric"], rel)
        assert rel <= metric_rel, (what, k, got_m[k], want_m[k])
    for which, tol in (("m", moment_rel),
                       ("v", moment_rel * (2 if quantised else 1))):
        for i, (a, b) in enumerate(zip(got[which], want[which])):
            seen[which] = max(seen[which], _rel_err(a, b))
            assert _rel_err(a, b) <= tol, (what, which, i, _rel_err(a, b))
    eps, b1 = opt_of().eps, opt_of().b1
    for i, (a, b, m) in enumerate(zip(got["params"], want["params"],
                                      want["m"])):
        cut = 1.01 * np.max(np.abs(m)) / 127 if quantised \
            else 100 * eps * (1 - b1)
        ill = np.abs(m) <= cut
        err = np.abs(a - b) / LR
        well = float(np.max(err[~ill])) if (~ill).any() else 0.0
        bad = float(np.max(err[ill])) if ill.any() else 0.0
        seen["param_lr"] = max(seen["param_lr"], well)
        seen["ill_param_lr"] = max(seen["ill_param_lr"], bad)
        seen["ill"] += int(ill.sum())
        assert well <= param_lr and bad <= ILL_LR, (what, i, well, bad)
    print(what, seen)
    return seen


def _ref_as_state(ref):
    """The reference's npz in the port's leaf order (jax's keystr paths
    sort as the port's dict keys do)."""
    out = {}
    for what in ("params", "m", "v"):
        _, vals = _ref_leaves(ref, what)
        out[what] = vals
    return out, {k[len("metric/"):]: float(v) for k, v in ref.items()
                 if k.startswith("metric/")}


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != (1, 1)],
                         ids=case_id)
def test_sharded_step_matches_the_reference(run, case):
    got = run["ranks"][0]["steps"][case_id(case)]
    want_state, want_m = _ref_as_state(run["ref"][case_id(case)])
    assert set(got["metrics"]) == set(want_m)
    _hold(got["metrics"], got, want_m, want_state, case_id(case),
          HOIST_MOMENT_REL if case[1] else
          QUANTUM_REL if case[3] else STEP_REL, quantised=case[3],
          metric_rel=HOIST_METRIC_REL if case[1] else STEP_REL,
          param_lr=ILL_LR if case[1] else PARAM_STEP_LR)


def test_mesh_of_one_matches_the_reference(run):
    """(1, 1): no process group; the reference hoists and takes B
    microbatches there too."""
    case = CASES[0]
    cfg = cfg_of(case[1])
    params = from_reference(run["tree"], cfg, device=CPU, cast=False)
    st = init_opt_state(params, opt_of())
    p, o, m = make_train_step(cfg, opt_of(), ctx=make_ctx(small_mesh(1, 1)))(
        params, st, {"tokens": torch.from_numpy(run["toks"])})
    got = {"params": [x.numpy() for x in leaves(p)],
           "m": [x.numpy() for x in leaves(o["m"])],
           "v": [x.numpy() for x in leaves(o["v"])]}
    want_state, want_m = _ref_as_state(run["ref"][case_id(case)])
    _hold({k: float(v) for k, v in m.items()}, got, want_m, want_state,
          "(1, 1)")


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != (1, 1)],
                         ids=case_id)
def test_sharded_step_matches_the_single_device_step(run, case):
    (d, m), hoist, mb, comp = case
    got = run["ranks"][0]["steps"][case_id(case)]
    dp = d
    single_mb = mb if mb is not None else B // dp
    want_m, want = _single_step(run["tree"], run["toks"], single_mb, comp)
    if hoist:
        for k, tol in HOIST_SINGLE.items():
            assert abs(got["metrics"][k] - want_m[k]) <= tol * abs(
                want_m[k]), (k, got["metrics"][k], want_m[k])
        return
    _hold(got["metrics"], got, want_m, want, case_id(case) + " vs one",
          QUANTUM_REL if comp else STEP_REL, quantised=comp)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != (1, 1)],
                         ids=case_id)
def test_each_rank_holds_the_bytes_its_specs_give(run, case):
    (d, m), _, _, comp = case
    per_rank = [r["bytes"][case_id(case)] for r in run["ranks"][:d * m]]
    assert all(case_id(case) not in r["bytes"] for r in
               run["ranks"][d * m:])
    for b in per_rank:
        assert b["params"] == b["spec"]
        assert b["moments"] == 2 * b["spec"]      # fp32 moments
    # independently: the reference's specs on this mesh, each leaf's
    # bytes over the ranks its spec spreads it across
    cfg = cfg_of()
    from unittest import mock
    with mock.patch.object(jtrain_step, "_ns", lambda ctx, spec: spec):
        ref = jtrain_step.param_shardings(
            jget_config(ARCH).smoke(), jmesh.make_ctx(_standin(d, m)))
    sizes = {"data": d, "model": m}
    full = from_reference(run["tree"], cfg, device=CPU, cast=False)
    want = 0
    for (_, spec), t in zip(_flat(ref), leaves(full)):
        k = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                k *= sizes[a]
        want += t.numel() * t.element_size() // k
    assert per_rank[0]["params"] == want
    assert want < per_rank[0]["full"] // (d * m) + 4096


def test_collectives_per_step(run):
    """Unhoisted, every sharded leaf is gathered once per microbatch;
    hoisted, once per step. One metrics all-reduce and one norm
    all-reduce; compression adds one amax all-reduce."""
    steps = run["ranks"][0]["steps"]
    plain = steps["2x1-hoist0-mb2"]["counters"]["calls"]
    hoisted = steps["2x1-hoist1-mb2"]["counters"]["calls"]
    assert plain["all_gather"] == 2 * hoisted["all_gather"]
    assert plain["reduce_scatter"] == hoisted["reduce_scatter"] > 0
    comp = steps["2x1-hoist0-mbNone-compress"]["counters"]["calls"]
    assert comp["all_reduce_max"] == 1
    assert plain.get("all_reduce_max", 0) == 0


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != (1, 1)],
                         ids=case_id)
def test_dry_run_predicts_each_rank_s_collectives_and_bytes(run, case):
    """The step of ``case`` on the meta device, each rank with a dry-run
    group (``repro_torch.distributed.op_analysis``): its collective
    counters (calls and largest bytes, by kind) equal the ones the live
    gloo step recorded on that rank, and its argument bytes the rank's
    live blocks of the masters and moments (compression's bf16 error
    state too), the step count and the global batch, exactly."""
    (d, m), hoist, mb, comp = case
    mesh = small_mesh(d, m)
    for rank in range(d * m):
        cost = StepCost()
        ctx = make_ctx(mesh, DryMeshGroup(mesh, rank, cost))
        step, args, _ = train_input_specs(
            cfg_of(hoist), ctx, ShapeSpec("t", S, B, "train"), opt=opt_of(),
            compress=comp, microbatches=mb)
        analyze_step(step, *args, cost=cost)
        live = run["ranks"][rank]
        assert ctx.group.counters() == \
            live["steps"][case_id(case)]["counters"], (case, rank)
        b = live["bytes"][case_id(case)]
        want = b["params"] + b["moments"] + 4 + B * S * 4 \
            + (b["params"] // 2 if comp else 0)
        assert cost.argument_bytes == want, (case, rank)


def test_elastic_restore_across_rank_counts(run):
    """1 -> 2 and 1 -> 4, 2 -> 4 and 4 -> 2: every rank's restored blocks
    equal the blocks of the whole state."""
    el = run["ranks"][0]["elastic"]
    assert set(el) == {"ckpt1->ckpt2", "ckpt1->ckpt4", "ckpt2->ckpt2to4",
                       "ckpt4->ckpt4to2"}
    for r, ranks in enumerate(run["ranks"]):
        for k, v in ranks["elastic"].items():
            assert v["equal"], (r, k)


@pytest.mark.parametrize("saved", ["ckpt2", "ckpt4", "ckpt2to4",
                                   "ckpt4to2"])
def test_sharded_save_is_the_single_device_bytes(run, saved):
    root = run["root"]
    a, b = root / "ckpt1", root / saved
    names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(b) for p in b.rglob("*")
                           if p.is_file())
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.mark.parametrize("saved", ["ckpt2", "ckpt4"])
def test_sharded_save_restores_at_one_rank_and_in_the_reference(run, saved):
    root, whole = run["root"], run["whole"]
    got = CheckpointManager(str(root / saved)).restore(5, whole, CPU)
    for a, b in zip(leaves(got), leaves(whole)):
        assert torch.equal(a, b)
    ex = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.numpy().dtype),
                                whole)
    ref = JCheckpointManager(root / saved).restore(5, ex)
    for a, b in zip(jax.tree_util.tree_leaves(ref), leaves(whole)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _trainer_single(root):
    return trainer_run(get_config(ARCH).smoke(), None, root, "tr_single", None)


def test_trainer_restarts_from_its_checkpoint_and_ends_where_a_run_ends(run):
    tr = run["ranks"][0]["trainer"]
    plain, again = tr["plain"], tr["restarted"]
    assert plain["restarts"] == 0 and again["restarts"] == 1
    assert plain["step"] == again["step"] == TRAIN_TC["total_steps"]
    assert again["steps_saved"] == [2, 4]
    for a, b in zip(plain["params"], again["params"]):
        np.testing.assert_array_equal(a, b)
    # rank 0 keeps the history: the re-run step 2 logged twice
    assert [h["step"] for h in again["history"]] == [0, 1, 2, 2, 3]
    assert run["ranks"][1]["trainer"]["plain"]["history"] == []
    assert run["ranks"][2]["trainer"] is None


def test_trainer_on_two_ranks_stays_with_the_one_rank_trainer(run):
    """The fp32 masters after 4 steps (bf16 compute, one sequence per
    microbatch: the 2-rank loss is the mean of the ranks' rows, whose sum
    runs in another order): within 5e-2 x lr x steps."""
    two = run["ranks"][0]["trainer"]["plain"]
    one = _trainer_single(run["root"])
    for h1, h2 in zip(one["history"], two["history"]):
        assert abs(h1["loss"] - h2["loss"]) <= 1e-4 * abs(h1["loss"])
    for a, b in zip(one["params"], two["params"]):
        assert float(np.max(np.abs(a - b))) <= PARAM_STEP_LR * LR * 4


def test_a_failing_rank_fails_the_session_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        with MeshSession(2, "gloo", fail_on_rank_one, CPU, timeout=120.0,
                         init_method=f"file://{tmp_path / 'store'}",
                         op_timeout_s=30.0) as s:
            s.run()


def test_rank_zero_stuck_on_a_dead_rank_reports_its_traceback(tmp_path):
    """Rank 1 dies before a collective; rank 0's all-reduce fails on the
    closed connection (or its timeout), and the session raises with rank
    1's traceback."""
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        with MeshSession(2, "gloo", fail_then_reduce, CPU, timeout=120.0,
                         init_method=f"file://{tmp_path / 'store'}",
                         op_timeout_s=30.0) as s:
            s.run()


def test_the_cli_runs_on_cuda_unless_asked(monkeypatch):
    """``python -m repro_torch.bench.train_mesh`` without ``--device``
    wants CUDA and raises here, before any rank is spawned."""
    from repro_torch.bench import train_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mesh.main(["--steps", "1"])

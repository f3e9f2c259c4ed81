"""The sharded train step with its products partitioned over the ``model``
axis (column- and row-parallel products, the vocab-parallel embedding,
head and loss, Mamba1 on ``dI / tp`` channels, Mamba2 on ``nh / tp``
heads, zamba2's shared block, the MoE layer's experts split by expert or
by hidden dim, attention whole where ``tp`` does not divide the query
heads), and the MoE router's aux loss over the global batch, on the CPU.

* The arch table: which archs partition on which meshes
  (``tp_compute``), and each leaf's plan (``tp_plan``), in-process.
* One spawned ``gloo`` group of 4 CPU ranks for the module (rank 0 is this
  process; 60 s op timeouts; what the ranks run is in
  ``tests/test_torch_train_tp_ranks.py``) beside one reference subprocess
  with 4 virtual devices running the reference's sharded step on the same
  meshes and weights (its ``PRNGKey(0)`` init): stablelm-1.6b smoke on
  (1, 2), (2, 2) and (1, 4) (where 4 does not divide the 2 KV heads),
  hoisted and not, ``microbatches`` None, 1 and 2 and compression;
  falcon-mamba-7b smoke on (1, 2) (the ``in_proj`` exchange); qwen2-moe
  smoke on (2, 1) (the aux loss and the dispatch over the global batch),
  on (1, 2) split by expert with the aux loss weighted 1.0, on (2, 2)
  hoisted (the global batch's routing and the expert split), with 5
  experts on (1, 2) (the hidden-dim split) and with 6 and 2 inert ones on
  (1, 4); arctic smoke on (1, 2) (the dense residual), with fp32 masters
  and with its own bf16 ones (held to the hoisted bounds); zamba2-1.2b
  smoke on (1, 2), on (1, 4) (blocks of the fused ``in_proj`` that mix its
  parts) and on (2, 2) hoisted; internvl2-1b smoke with 14 query heads on
  (1, 4) (attention whole on every rank), its frames in the batch; and
  stablelm with an MLP width of 90 on (1, 4) (the MLP whole).
  Each case is held against the reference's step and the port's
  single-device step with ``tests/test_torch_train_mesh.py``'s tolerances;
  each rank's collectives against the dry run's prediction; the leaves no
  spec shards over ``model`` against every other model rank's.
* The dry run: each rank's FLOPs are exactly 1/tp of one device's for the
  same rows, but for what every rank forms whole (a MoE arch's router and
  shared gate, Mamba2's B and C, attention kept whole); on (1, 2) no leaf
  is all-gathered.
* A checkpoint saved by a (1, 2) run restores at one rank and in the
  reference's ``CheckpointManager``.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch.configs import ARCHS, ShapeSpec, get_config
from repro_torch.distributed.op_analysis import (DryMeshGroup, StepCost,
                                                 analyze_step,
                                                 replicated_flops)
from repro_torch.distributed.sharding import (Mesh, exchange_fused,
                                              tp_compute, tp_compute_why,
                                              tp_whole)
from repro_torch.launch.mesh import MeshSession, make_ctx, small_mesh
from repro_torch.optim import init_error_state, init_opt_state
from repro_torch.params import from_reference
from repro_torch.train import CheckpointManager
from repro_torch.train.train_step import (make_train_step, param_shapes,
                                          tp_plan, train_input_specs)
from repro_torch.tree import leaves, tree_map
from test_torch_train_mesh import (HOIST_METRIC_REL, HOIST_MOMENT_REL,
                                   ILL_LR, PARAM_STEP_LR,
                                   QUANTUM_REL, STEP_REL, _hold,
                                   _ref_as_state)
from test_torch_train_tp_ranks import (B, CASES, LR, SAVED, S, Body,
                                       case_id, cfg_of, opt_of, to_numpy,
                                       torch_batch, tree_key)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TREES = sorted({tree_key(c) for c in CASES})


# ------------------------------------------------------- the arch table
#: arch -> (partitions on the (1, 2) smoke mesh, on the dry run's
#: node_tp (2, 4) mesh at full width)
TP_TABLE = {
    "stablelm-1.6b": (True, True),
    "qwen2.5-32b": (True, True),
    "qwen3-14b": (True, True),
    "mistral-nemo-12b": (True, True),
    "musicgen-large": (True, True),
    "internvl2-1b": (True, True),       # node_tp: attention whole
    "falcon-mamba-7b": (True, True),
    "qwen2-moe-a2.7b": (True, True),
    "arctic-480b": (True, True),
    "zamba2-1.2b": (True, True),
}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_arch_table(arch):
    smoke, full = TP_TABLE[arch]
    assert tp_compute(get_config(arch).smoke(),
                      make_ctx(small_mesh(1, 2))) == smoke
    assert tp_compute(get_config(arch),
                      make_ctx(Mesh((2, 4), ("data", "model")))) == full
    # no model axis above 1: never partitioned
    assert not tp_compute(get_config(arch).smoke(),
                          make_ctx(small_mesh(2, 1)))
    assert tp_compute_why(get_config(arch).smoke(),
                          make_ctx(small_mesh(2, 1))) \
        == "no model axis above 1"
    plan = tp_plan(get_config(arch).smoke(), make_ctx(small_mesh(2, 2)))
    assert bool(plan) == smoke
    # what runs whole on node_tp: only internvl2's attention (14 heads)
    assert tp_whole(get_config(arch), 4) == (
        {"attn": "model axis 4 does not divide the query heads (14)"}
        if arch == "internvl2-1b" else {})


def test_the_plan_of_each_leaf():
    """stablelm keeps every tp block; at tp = 4 its 2 KV heads come whole
    and their gradients are summed over tp; qwen3's head norms are summed;
    falcon-mamba's in_proj is exchanged; the MoE archs keep their experts'
    blocks (by expert, or by hidden dim where tp does not divide E) and
    their shared experts' or dense residual's, and take the router and the
    shared gate whole."""
    def plan_of(arch, mesh, **over):
        cfg = dataclasses.replace(get_config(arch).smoke(), **over)
        ctx = make_ctx(small_mesh(*mesh))
        names = [n for n, _ in _named(param_shapes(cfg))]
        return dict(zip(names, tp_plan(cfg, ctx)))

    p = plan_of("stablelm-1.6b", (1, 2))
    assert {k for k, v in p.items() if v == "whole"} == {
        "blocks/ln1", "blocks/ln2", "final_norm"}
    assert set(p.values()) == {"whole", "block"}
    p4 = plan_of("stablelm-1.6b", (1, 4))
    assert p4["blocks/wk"] == p4["blocks/wv"] == "sum"
    assert p4["blocks/wq"] == "block"
    q = plan_of("qwen3-14b", (1, 2))
    assert q["blocks/q_norm"] == q["blocks/k_norm"] == "sum"
    f = plan_of("falcon-mamba-7b", (1, 2))
    assert f["blocks/in_proj"] == "xz" and f["blocks/A_log"] == "block"
    experts = {"blocks/e_wi", "blocks/e_wg", "blocks/e_wd"}
    shared = {"blocks/shared_wi", "blocks/shared_wg", "blocks/shared_wd"}
    dense = {"blocks/dense_wi", "blocks/dense_wg", "blocks/dense_wd"}
    for arch, mesh, mlps in (("qwen2-moe-a2.7b", (1, 2), shared),
                             ("qwen2-moe-a2.7b", (1, 4), shared),
                             ("arctic-480b", (1, 2), dense)):
        m = plan_of(arch, mesh)
        assert {k for k, v in m.items() if v == "block"} >= experts | mlps
        assert m["blocks/router"] == "whole"
        assert m.get("blocks/shared_gate", "whole") == "whole"
        kv = "block" if mesh[1] == 2 else "sum"
        assert m["blocks/wk"] == m["blocks/wv"] == kv
    q = plan_of("qwen2-moe-a2.7b", (1, 4))
    assert q["blocks/bq"] == "block" and q["blocks/bk"] == "sum"
    h = plan_of("qwen2-moe-a2.7b", (1, 2), num_experts=5)
    assert all(h[k] == "block" for k in experts)
    for mesh in ((1, 2), (1, 4)):
        z = plan_of("zamba2-1.2b", mesh)
        for stack in ("gblocks", "tail_blocks"):
            assert z[f"{stack}/in_proj"] == "zxbcdt"
            assert z[f"{stack}/conv_w"] == z[f"{stack}/conv_b"] == "xbc"
            for leaf in ("A_log", "dt_bias", "ssm_D", "ssm_norm",
                         "out_proj"):
                assert z[f"{stack}/{leaf}"] == "block"
        assert z["shared_block/fused_proj"] == "block"
        assert z["shared_block/wq"] == z["shared_block/wd"] == "block"
        kv = "block" if mesh[1] == 2 else "sum"
        assert z["shared_block/wk"] == z["shared_block/wv"] == kv
    v = plan_of("internvl2-1b", (1, 4), num_heads=14)
    attn = {f"blocks/{k}" for k in ("wq", "wk", "wv", "wo", "bq", "bk",
                                    "bv")}
    assert {k for k, h in v.items() if h == "whole"} == attn | {
        "blocks/ln1", "blocks/ln2", "final_norm"}
    assert v["embed"] == v["blocks/wi"] == v["blocks/wd"] == "block"
    w = plan_of("stablelm-1.6b", (1, 4), d_ff=90)
    assert w["blocks/wi"] == w["blocks/wg"] == w["blocks/wd"] == "whole"
    assert w["blocks/wq"] == w["embed"] == "block"


class _Exchange:
    """A stand-in for one rank's group in an all-to-all over every rank
    of a (1, n) mesh, run in turns: the first pass records each rank's
    send buffer, the second hands each rank the rows the others sent."""

    def __init__(self, n, sent=None):
        self.mesh, self.sent, self.rank = small_mesh(1, n), sent, 0

    def all_to_all(self, x, axes, send, recv):
        if self.sent is None or self.rank not in self.sent:
            self.sent = self.sent or {}
            self.sent[self.rank] = (list(x.split(list(send))), recv)
            return x.new_zeros((sum(recv),) + tuple(x.shape[1:]))
        n = self.mesh.size
        return torch.cat([self.sent[j][0][self.rank] for j in range(n)])


@pytest.mark.parametrize("n", [2, 3, 4])
def test_in_proj_exchange_brings_each_rank_its_x_and_z_columns(n):
    """Mamba1's ``in_proj`` stored as contiguous column blocks (rank r:
    columns [2r c, 2(r + 1) c) of x | z) comes to rank r as [x_r | z_r],
    and the inverse takes it back, for an even and an odd model axis."""
    dI, D, c = 6 * n, 5, 6
    xz = [(dI, True), (dI, True)]
    full = torch.arange(D * 2 * dI, dtype=torch.float32).reshape(D, 2 * dI)
    blocks = full.split(2 * c, dim=1)
    g = _Exchange(n)
    for r in range(n):                       # every rank sends
        g.rank = r
        exchange_fused(g, blocks[r], ("model",), 1, xz)
    for r in range(n):                       # every rank receives
        g.rank = r
        got = exchange_fused(g, blocks[r], ("model",), 1, xz)
        want = torch.cat([full[:, r * c:(r + 1) * c],
                          full[:, dI + r * c:dI + (r + 1) * c]], dim=1)
        assert torch.equal(got, want), r
    back = _Exchange(n)
    for phase in range(2):
        for r in range(n):
            back.rank = r
            x = torch.cat([full[:, r * c:(r + 1) * c],
                           full[:, dI + r * c:dI + (r + 1) * c]], dim=1)
            out = exchange_fused(back, x, ("model",), 1, xz, inverse=True)
            if phase:
                assert torch.equal(out, blocks[r]), r


@pytest.mark.parametrize("n", [2, 3, 4])
def test_fused_exchange_brings_split_parts_cut_and_whole_parts_whole(n):
    """Mamba2's ``in_proj`` (z | x | B | C | dt, B and C whole on every
    rank) stored as contiguous blocks that mix the parts comes to rank r
    as [z_r | x_r | B | C | dt_r]; the inverse brings each rank's gradient
    back to the stored blocks and sums the whole parts' over the ranks."""
    dI, N, nh, D = 4 * n, n, 2 * n, 2
    parts = [(dI, True), (dI, True), (N, False), (N, False), (nh, True)]
    W = 2 * dI + 2 * N + nh
    c = W // n                       # 12: rank 1 of 2 holds x, B, C, dt
    full = torch.arange(D * W, dtype=torch.float64).reshape(D, W)
    blocks = full.split(c, dim=1)
    los = np.cumsum([0] + [w for w, _ in parts])

    def computed(r, t):
        return torch.cat([t[:, lo + r * w // n:lo + (r + 1) * w // n]
                          if split else t[:, lo:lo + w]
                          for (w, split), lo in zip(parts, los)], dim=1)

    g = _Exchange(n)
    for phase in range(2):
        for r in range(n):
            g.rank = r
            got = exchange_fused(g, blocks[r], ("model",), 1, parts)
            if phase:
                assert torch.equal(got, computed(r, full)), r
    # rank r's gradient of its computed columns: (r + 1) x the values
    back = _Exchange(n)
    for phase in range(2):
        for r in range(n):
            back.rank = r
            out = exchange_fused(back, (r + 1) * computed(r, full),
                                 ("model",), 1, parts, inverse=True)
            if phase:
                want = full.clone()
                for (w, split), lo in zip(parts, los):
                    if not split:      # summed over the ranks
                        want[:, lo:lo + w] *= n * (n + 1) // 2
                    else:              # each column from the rank using it
                        for j in range(n):
                            a, b = lo + j * w // n, lo + (j + 1) * w // n
                            want[:, a:b] *= j + 1
                assert torch.equal(out, want[:, r * c:(r + 1) * c]), r


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


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
opt = OptConfig(lr=lr, warmup_steps=0, total_steps=10)
for name, arch, (d, m), hoist, mb, comp, over in cases:
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              compute_dtype="float32",
                              hoist_weight_gather=hoist, **dict(over))
    batch = {"tokens": jnp.asarray(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = jnp.asarray(
            np.random.default_rng(2).standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model), dtype=np.float32))
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
    batch = jax.device_put(batch, batch_shardings(cfg, ctx))
    with mesh:
        p2, o2, met = jax.jit(step)(params, st, batch)
    out = {f"metric/{k}": np.asarray(v) for k, v in met.items()}
    for what, tree in (("params", p2), ("m", o2["m"]), ("v", o2["v"])):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            out[what + jax.tree_util.keystr(path)] = np.asarray(
                leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16
                else leaf)
    np.savez(f"{out_dir}/{name}.npz", **out)
print("ref done", flush=True)
"""


#: the reference's jitted steps run in this many subprocesses (cases dealt
#: round-robin), each compiling its cases serially on one thread: one
#: process compiling every case took longer than the port's group
REF_PROCS = 2


def _start_reference(out_dir, cases):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=str(ROOT / "src"))
    arg = json.dumps([[[case_id(c), c[0], list(c[1]), c[2], c[3], c[4],
                        c[5]] for c in cases], str(out_dir), LR, B, S])
    return subprocess.Popen(["nice", "-n", "10", sys.executable, "-c",
                             REF_SCRIPT, arg],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _ref_tree(arch, over):
    cfg = dataclasses.replace(jget_config(arch).smoke(),
                              compute_dtype="float32", **dict(over))
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_tp")
    (root / "ref").mkdir()
    procs = [_start_reference(root / "ref", CASES[i::REF_PROCS])
             for i in range(REF_PROCS)]
    try:
        trees = {k: _ref_tree(*k) for k in TREES}
        with MeshSession(4, "gloo", Body(trees, str(root)), CPU,
                         init_method=f"file://{root / 'store'}",
                         timeout=300.0, op_timeout_s=60.0) as s:
            s.run()
        res = {"ranks": s.results, "trees": trees, "root": root}
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    res["ref"] = {case_id(c): dict(np.load(root / "ref"
                                           / f"{case_id(c)}.npz"))
                  for c in CASES}
    return res


def _single_step(tree, case):
    """The case's step on one device: the single-device step, or with the
    gather hoisted the step on a (1, 1) mesh, whose weights are the same
    bf16 copies."""
    arch, (d, _), hoist, mb, comp, over = case
    cfg = cfg_of(arch, hoist, over)
    params = from_reference(tree, cfg, device=CPU, cast=False)
    st = init_opt_state(params, opt_of())
    if comp:
        st["err"] = init_error_state(params)
    mb = mb if mb is not None else B // d
    ctx = make_ctx(small_mesh(1, 1)) if hoist else None
    p, o, m = make_train_step(cfg, opt_of(), compress=comp,
                              microbatches=mb, ctx=ctx)(
        params, st, torch_batch(case))
    return ({k: float(v) for k, v in m.items()},
            {"params": [to_numpy(x) for x in leaves(p)],
             "m": [to_numpy(x) for x in leaves(o["m"])],
             "v": [to_numpy(x) for x in leaves(o["v"])]})


def _bounds(case):
    """(moment_rel, quantised, metric_rel, param_lr) of a case: the hoisted
    bounds for a hoisted gather or bf16 masters (BF16_MASTERS: its bf16
    gradients round differently where two summation orders differ),
    compression's quantum, else the step's."""
    hoist, comp = case[2], case[4]
    if hoist or case in BF16_MASTERS:
        return HOIST_MOMENT_REL, False, HOIST_METRIC_REL, ILL_LR
    return (QUANTUM_REL if comp else STEP_REL), comp, STEP_REL, PARAM_STEP_LR


#: cases whose masters (and so gradients and moments) are bf16
BF16_MASTERS = [c for c in CASES if cfg_of(c[0], over=c[5]).param_dtype
                == "bfloat16"]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_partitioned_step_matches_the_reference(run, case):
    got = run["ranks"][0][case_id(case)]
    want_state, want_m = _ref_as_state(run["ref"][case_id(case)])
    assert set(got["metrics"]) == set(want_m)
    moment_rel, quantised, metric_rel, param_lr = _bounds(case)
    _hold(got["metrics"], got, want_m, want_state, case_id(case),
          moment_rel, quantised=quantised, metric_rel=metric_rel,
          param_lr=param_lr)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_partitioned_step_matches_the_single_device_step(run, case):
    """Unhoisted, against the single-device step; hoisted, against the
    (1, 1) mesh's step (no group: the same bf16 weights, whole), with the
    hoisted bounds."""
    got = run["ranks"][0][case_id(case)]
    want_m, want = _single_step(run["trees"][tree_key(case)], case)
    moment_rel, quantised, metric_rel, param_lr = _bounds(case)
    _hold(got["metrics"], got, want_m, want, case_id(case) + " vs one",
          moment_rel, quantised=quantised, metric_rel=metric_rel,
          param_lr=param_lr)


def test_moe_aux_loss_is_the_global_batch_s(run):
    """qwen2-moe on (2, 1): every rank's aux metric is the reference's
    global-batch value (each rank's over its own rows, averaged, is not:
    the loss is not linear in the batch)."""
    case = next(c for c in CASES if c[0] == "qwen2-moe-a2.7b")
    want = float(run["ref"][case_id(case)]["metric/aux"])
    for r in run["ranks"][:2]:
        got = r[case_id(case)]["metrics"]["aux"]
        assert abs(got - want) <= STEP_REL * abs(want), (got, want)


@pytest.mark.parametrize("case", [c for c in CASES if c[1][1] > 1],
                         ids=case_id)
def test_replicated_leaves_agree_over_the_model_axis(run, case):
    """The leaves no spec shards over ``model`` (the norms) get the same
    gradient on every model rank: after the step each rank of a data
    coordinate holds the same bytes."""
    d, m = case[1]
    for i in range(d):
        held = [run["ranks"][i * m + j][case_id(case)]["replicated"]
                for j in range(m)]
        assert held[0]
        for other in held[1:]:
            assert other.keys() == held[0].keys()
            for k in held[0]:
                np.testing.assert_array_equal(other[k], held[0][k])


@functools.lru_cache(maxsize=None)
def _dry(case, rank, mesh=None):
    arch, shape, hoist, mb, comp, over = case
    m = small_mesh(*(mesh or shape))
    cost = StepCost()
    ctx = make_ctx(m, DryMeshGroup(m, rank, cost))
    step, args, _ = train_input_specs(
        cfg_of(arch, hoist, over), ctx, ShapeSpec("t", S, B, "train"),
        opt=opt_of(), compress=comp, microbatches=mb)
    analyze_step(step, *args, cost=cost)
    return ctx.group, cost


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_dry_run_predicts_each_rank_s_collectives(run, case):
    d, m = case[1]
    for rank in range(d * m):
        group, _ = _dry(case, rank)
        assert group.counters() == \
            run["ranks"][rank][case_id(case)]["counters"], (case, rank)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "falcon-mamba-7b"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_each_rank_s_flops_are_one_tp_th_of_one_device_s(arch, mesh):
    """The same rows on a mesh without the model axis and with it: the
    dry run's FLOPs of a rank (every product: the projections, the
    attention scores, the scan, the head, forward and backward) are
    exactly 1/tp; qwen2-moe's are 1/tp but for its router and shared
    gate, which every rank forms whole."""
    case = (arch, mesh, False, None, False, ())
    _, alone = _dry(case, 0, mesh=(mesh[0], 1))
    for rank in range(mesh[0] * mesh[1]):
        _, part = _dry(case, rank)
        assert part.flops * mesh[1] == alone.flops, (rank, part.flops,
                                                     alone.flops)
    moe = ("qwen2-moe-a2.7b", mesh, False, None, False, ())
    one = _dry(moe, 0, mesh=(mesh[0], 1))[1].flops
    R = replicated_flops(cfg_of(moe[0]), B // mesh[0], S, mesh[1])
    assert R > 0
    assert _dry(moe, 0)[1].flops == (one - R) / mesh[1] + R


def _kv_repeat(cfg, rows, tp):
    """The FLOPs of the KV projections a rank forms beyond its 1/tp share
    where tp does not divide the KV heads: it projects the KV heads its
    query heads read (forward, recompute, two gradient products)."""
    if cfg.num_kv_heads % tp == 0:
        return 0.0
    read = max(1, (cfg.num_heads // tp)
               // (cfg.num_heads // cfg.num_kv_heads))
    width = 2 * cfg.hd * read                # its heads of wk and of wv
    share = 2 * cfg.num_kv_heads * cfg.hd / tp
    return 8.0 * rows * cfg.d_model * (width - share) * cfg.num_layers


MOE_TP = [c for c in CASES if c[1][1] > 1
          and c[0] in ("qwen2-moe-a2.7b", "arctic-480b")]


@pytest.mark.parametrize("case", MOE_TP, ids=case_id)
def test_a_moe_rank_s_flops_are_its_share_and_the_router_s(case):
    """Split by expert, by hidden dim or with inert experts, with the
    shared experts or the dense residual: a rank's FLOPs are exactly
    ``(F1 - R) / tp + R`` (R the router's and the shared gate's products,
    :func:`replicated_flops`), and where 4 does not divide the 2 KV heads
    the one KV head each rank projects whole on top."""
    d, m = case[1]
    cfg = cfg_of(case[0], case[2], case[5])
    rows = B * S // d
    one = _dry(case, 0, mesh=(d, 1))[1].flops
    R = replicated_flops(cfg, B // d, S, m)
    want = (one - R) / m + R + _kv_repeat(cfg, rows, m)
    for rank in range(d * m):
        assert _dry(case, rank)[1].flops == want, (rank, want)


@pytest.mark.parametrize("case", [
    ("zamba2-1.2b", (1, 2), False, None, False, ()),
    ("internvl2-1b", (1, 4), False, 1, False, (("num_heads", 14),))],
    ids=case_id)
def test_a_rank_s_flops_are_its_share_and_the_whole_work(case):
    """zamba2 on (1, 2): a rank's FLOPs are exactly ``(F1 - R) / tp + R``,
    R each Mamba2 layer's B and C columns of ``in_proj`` and its SSD's C
    B^T (every head reads them); internvl2 with 14 query heads on (1, 4):
    R its attention, whole on every rank (:func:`replicated_flops`)."""
    d, m = case[1]
    cfg = cfg_of(case[0], case[2], case[5])
    one = _dry(case, 0, mesh=(d, 1))[1].flops
    R = replicated_flops(cfg, B // d, S, m)
    assert 0 < R < one
    for rank in range(d * m):
        assert _dry(case, rank)[1].flops == (one - R) / m + R, rank


@pytest.mark.parametrize("case", MOE_TP, ids=case_id)
def test_each_rank_holds_its_experts(run, case):
    """A rank's expert leaves are its E / tp experts where tp divides E
    (the padded count), else every expert's 1 / tp of the hidden width;
    its shared experts' or dense residual's its 1 / tp of their width."""
    d, m = case[1]
    cfg = cfg_of(case[0], case[2], case[5])
    L, D = cfg.num_layers, cfg.d_model
    E, Fe = cfg.num_experts + cfg.moe_expert_pad, cfg.moe_d_ff
    wi = (L, E // m, D // d, Fe) if E % m == 0 else (L, E, D // d, Fe // m)
    wd = (L, E // m, Fe, D // d) if E % m == 0 else (L, E, Fe // m, D // d)
    mlp, width = ("shared_", cfg.shared_expert_d_ff) \
        if cfg.shared_expert_d_ff else ("dense_", cfg.d_ff)
    for rank in range(d * m):
        shapes = run["ranks"][rank][case_id(case)]["shapes"]
        assert shapes["blocks/e_wi"] == shapes["blocks/e_wg"] == wi
        assert shapes["blocks/e_wd"] == wd
        assert shapes[f"blocks/{mlp}wi"] == (L, D // d, width // m)
        assert shapes[f"blocks/{mlp}wd"] == (L, width // m, D // d)
        assert shapes["blocks/router"][1:] == (D // d, E)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == (1, 2)],
                         ids=case_id)
def test_one_by_two_gathers_no_leaf(run, case):
    """(1, 2): every leaf is either this rank's tp block as stored or
    replicated, so nothing is all-gathered; Mamba1's in_proj and Mamba2's
    in_proj and conv are one all-to-all a fetch. Each layer's forward sums
    its two row-parallel products over the model axis, its backward the
    gradients of its two column-parallel inputs. zamba2 all-gathers only
    its shared block's ``fused_proj`` output, an activation: once a group
    a microbatch and once more in remat's recompute."""
    cfg = cfg_of(case[0], case[2], case[5])
    for r in run["ranks"][:2]:
        counters = r[case_id(case)]["counters"]
        calls = counters["calls"]
        if cfg.hybrid_attn_every:
            mb = case[3] if case[3] is not None else B
            G = cfg.num_layers // cfg.hybrid_attn_every
            assert calls["all_gather"] == (1 + cfg.remat) * G * mb, calls
            # B // mb rows of S tokens, d_model fp32 columns, both ranks'
            assert counters["max_bytes"]["all_gather"] == \
                B // mb * S * cfg.d_model * 4, counters
        else:
            assert "all_gather" not in calls, calls
        assert "reduce_scatter" not in calls, calls
        assert ("all_to_all" in calls) == bool(cfg.ssm), calls


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "internvl2-1b"],
                         ids=case_id)
def test_a_rank_holds_its_quarter_of_what_partitions(run, case):
    """internvl2 with 14 query heads on (1, 4): each rank holds a quarter
    of each MLP, embedding and head leaf, and of ``wq`` (stored over the
    model axis as the reference stores it, though attention runs whole)."""
    cfg = cfg_of(case[0], case[2], case[5])
    L, D, m = cfg.num_layers, cfg.d_model, case[1][1]
    want = {"embed": (cfg.padded_vocab // m, D),
            "blocks/wi": (L, D, cfg.d_ff // m),
            "blocks/wg": (L, D, cfg.d_ff // m),
            "blocks/wd": (L, cfg.d_ff // m, D),
            "blocks/wq": (L, D, cfg.num_heads * cfg.hd // m)}
    for rank in range(m):
        shapes = run["ranks"][rank][case_id(case)]["shapes"]
        for k, v in want.items():
            assert shapes[k] == v, (rank, k, shapes[k], v)


def test_a_one_by_two_checkpoint_restores_at_one_rank_and_in_the_reference(
        run):
    case = CASES[SAVED]
    root = run["root"] / "ckpt"
    got = run["ranks"][0][case_id(case)]
    example = {"params": tree_map(lambda t: torch.empty(t.shape),
                                  param_shapes(cfg_of(case[0], case[2])))}
    example["opt"] = init_opt_state(example["params"], opt_of())
    whole = CheckpointManager(str(root)).restore(1, example, CPU)
    for what, key in (("params", ("params",)), ("m", ("opt", "m")),
                      ("v", ("opt", "v"))):
        tree = whole[key[0]] if len(key) == 1 else whole[key[0]][key[1]]
        for a, b in zip(leaves(tree), got[what]):
            np.testing.assert_array_equal(a.numpy(), b)
    ex = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.numpy().dtype),
                                whole)
    ref = JCheckpointManager(root).restore(1, ex)
    for a, b in zip(jax.tree_util.tree_leaves(ref), leaves(whole)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

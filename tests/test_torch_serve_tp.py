"""The sharded prefill and decode steps partitioned over the ``model``
axis, with the reference's sequence-parallel KV caches, on the CPU.

* One spawned ``gloo`` group of 4 CPU ranks for the module (rank 0 is this
  process; what the ranks run is in ``tests/test_torch_serve_tp_ranks.py``)
  beside one reference subprocess with 4 virtual devices, which runs the
  reference's ``lm.prefill`` and greedy ``lm.decode_step`` on one device
  and gives the reference's ``cache_shardings`` on each case's mesh.
* Fp32 smoke configs: stablelm-1.6b on (1, 2), (2, 2), (1, 4) (4 does not
  divide its 2 KV heads) and with one row on (2, 2) (S over both axes);
  qwen2-moe with a capacity factor low enough that tokens drop, on (2, 1)
  (its routing over the global batch) and (2, 2); falcon-mamba-7b and
  zamba2-1.2b on (1, 2); internvl2-1b with 14 query heads on (1, 4)
  (attention whole), its frames in the batch.
* For each: the prefill's logits and 4 greedy decode steps' logits are
  held to the reference's within ``tests/test_torch_decode_step.py``'s
  ``LOGIT_TOL``, the tokens equal, and the cache, assembled from the
  ranks' blocks, to ``STATE_TOL``; each rank's block is the slice the
  reference's ``cache_shardings`` gives that device (the specs compared
  leaf for leaf; Mamba2's conv buffer block in the layout the layer
  computes with), which the port's ``cache_shardings`` cuts from the
  reference's whole cache and assembles back; each rank's collectives
  equal the dry run's prediction, and a rank's dry-run FLOPs are exactly
  ``(F1 - R) / tp + R``.
"""
import dataclasses
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
from repro_torch.configs import ShapeSpec
from repro_torch.distributed.op_analysis import (DryMeshGroup, StepCost,
                                                 analyze_step,
                                                 replicated_flops)
from repro_torch.distributed.sharding import (NamedSharding, assemble_cache,
                                              cache_shardings, cache_specs,
                                              tp_whole)
from repro_torch.launch.mesh import MeshSession, make_ctx, small_mesh
from repro_torch.models import lm
from repro_torch.train.train_step import make_decode_step, make_prefill_step
from test_torch_decode_step import LOGIT_TOL, STATE_TOL
from test_torch_serve_tp_ranks import (CASES, STEPS, Body, S, cache_numpy,
                                       case_id, cfg_of, max_len_of,
                                       ref_key, shapes_of)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
REFS = sorted({ref_key(c) for c in CASES})

REF_SCRIPT = r"""
import dataclasses, functools, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import make_ctx, small_mesh
from repro.models import lm
from repro.train.train_step import cache_shardings
sys.path.insert(0, sys.argv[3])
from test_torch_serve_tp_ranks import (CASES, STEPS, batch_of, case_id,
                                       max_len_of, ref_key)

out_dir, cases = sys.argv[1], json.loads(sys.argv[2])
cases = [c for c in CASES if case_id(c) in cases]

def cfg_of(arch, over):
    return dataclasses.replace(get_config(arch).smoke(),
                               compute_dtype="float32", **dict(over))

def name_of(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)

specs = {}
for c in cases:
    arch, (d, m), B, over = c
    cfg = cfg_of(arch, over)
    shapes = jax.eval_shape(lambda: lm.init_cache(cfg, B, max_len_of(cfg)))
    sh = cache_shardings(cfg, make_ctx(small_mesh(d, m)), B, shapes)
    specs[case_id(c)] = {
        name_of(p): [list(e) if isinstance(e, tuple) else e
                     for e in s.spec]
        for p, s in jax.tree_util.tree_leaves_with_path(
            sh, is_leaf=lambda x: hasattr(x, "spec"))
        if name_of(p) != "pos"}
json.dump(specs, open(f"{out_dir}/specs.json", "w"))
done = set()
for c in cases:
    key = ref_key(c)
    if key in done:
        continue
    done.add(key)
    arch, _, B, over = c
    cfg = cfg_of(arch, over)
    params = lm.init_params(cfg, jax.random.PRNGKey(0))
    b = {k: jnp.asarray(v) for k, v in batch_of(c).items()}
    prefill = jax.jit(functools.partial(lm.prefill, cfg,
                                        max_len=max_len_of(cfg)))
    step = jax.jit(functools.partial(lm.decode_step, cfg))
    logits, cache = prefill(params, b["tokens"],
                            frontend_embeds=b.get("frontend_embeds"))
    res = {"prefill_logits": np.asarray(logits)}
    def leaves(cache, tag):
        for p, t in jax.tree_util.tree_leaves_with_path(cache):
            n = name_of(p)
            if n != "pos":
                res[f"{tag}/{n if '.' in n else n + '.0'}"] = np.asarray(t)
    leaves(cache, "cache0")
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = [tok]
    for i in range(STEPS):
        logits, cache = step(params, cache, tok)
        res[f"logits{i}"] = np.asarray(logits)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks.append(tok)
    leaves(cache, "cache")
    res["tokens"] = np.stack([np.asarray(t) for t in toks], axis=1)
    res["pos"] = np.asarray(cache["pos"])
    np.savez(f"{out_dir}/{arch}-{B}-{len(over)}.npz", **res)
print("ref done", flush=True)
"""


def _ref_file(key):
    arch, B, over = key
    return f"{arch}-{B}-{len(over)}.npz"


def _start_reference(out_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        ["nice", "-n", "10", sys.executable, "-c", REF_SCRIPT, str(out_dir),
         json.dumps([case_id(c) for c in CASES]), str(ROOT / "tests")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _ref_tree(arch, over):
    cfg = dataclasses.replace(jget_config(arch).smoke(),
                              compute_dtype="float32", **dict(over))
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_tp")
    (root / "ref").mkdir()
    proc = _start_reference(root / "ref")
    try:
        trees = {}
        for arch, _, over in REFS:
            trees.setdefault((arch, over), _ref_tree(arch, over))
        body = Body({k: trees[(k[0], k[2])] for k in REFS})
        with MeshSession(4, "gloo", body, CPU,
                         init_method=f"file://{root / 'store'}",
                         timeout=300.0, op_timeout_s=60.0) as s:
            s.run()
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    return {"ranks": s.results,
            "ref": {k: dict(np.load(root / "ref" / _ref_file(k)))
                    for k in REFS},
            "specs": json.loads((root / "ref" / "specs.json").read_text())}


def _ranks(run, case):
    d, m = case[1]
    return [r[case_id(case)] for r in run["ranks"][:d * m]]


def _port_specs(case):
    """The port's spec of each cache leaf (``name.i``) for the case."""
    arch, (d, m), B, over = case
    cfg = cfg_of(arch, over)
    cache = lm.init_cache(cfg, B, max_len_of(cfg), device="meta")
    specs = cache_specs(cfg, make_ctx(small_mesh(d, m)), B, cache)
    out = {}
    for k, s in specs.items():
        if k != "pos":
            for i, si in enumerate(s if isinstance(cache[k], tuple)
                                   else (s,)):
                out[f"{k}.{i}"] = si
    return cfg, cache, specs, out


def _shardings(case):
    """The port's :func:`cache_shardings` for the case, (cache, ``name.i``
    -> sharding)."""
    arch, (d, m), B, over = case
    cfg = cfg_of(arch, over)
    cache = lm.init_cache(cfg, B, max_len_of(cfg), device="meta")
    sh = cache_shardings(cfg, make_ctx(small_mesh(d, m)), B, cache)
    return cache, sh, {f"{k}.{i}": si for k, s in sh.items() if k != "pos"
                       for i, si in enumerate(
                           s if isinstance(cache[k], tuple) else (s,))}


def _assembled(case, blocks):
    """The whole cache (``name.i`` -> numpy) from the ranks' blocks."""
    cache, shardings, _ = _shardings(case)

    def tree(b):
        out = {}
        for k, v in cache.items():
            if k != "pos":
                n = len(v) if isinstance(v, tuple) else 0
                out[k] = tuple(torch.from_numpy(b[f"{k}.{i}"])
                               for i in range(n)) if n \
                    else torch.from_numpy(b[f"{k}.0"])
        return out

    shardings = {k: s for k, s in shardings.items() if k != "pos"}
    return cache_numpy(assemble_cache(shardings, [tree(b) for b in blocks]))


def _close(got, want, tol, what):
    """``assert_close``'s absolute bound."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= tol, (what, err, tol)


def _rows_of(ranks, key):
    """The global rows of a per-row result: each ``data`` coordinate's
    rows once, in order."""
    seen, out = set(), []
    for r in ranks:
        if r["rows"] not in seen:
            seen.add(r["rows"])
            out.append((r["rows"][0], r[key]))
    return np.concatenate([x for _, x in sorted(out, key=lambda t: t[0])])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_prefill_and_decode_logits_and_tokens_match_the_reference(run,
                                                                  case):
    ref = run["ref"][ref_key(case)]
    ranks = _ranks(run, case)
    _close(_rows_of(ranks, "prefill_logits"), ref["prefill_logits"],
           LOGIT_TOL, "prefill logits")
    for i in range(STEPS):
        for r in ranks:
            r[f"logits{i}"] = r["logits"][i]
        _close(_rows_of(ranks, f"logits{i}"), ref[f"logits{i}"], LOGIT_TOL,
               f"step {i} logits")
    np.testing.assert_array_equal(_rows_of(ranks, "tokens"), ref["tokens"])
    # every model rank of a data coordinate holds the same whole logits
    d, m = case[1]
    for i in range(d):
        for j in range(1, m):
            np.testing.assert_array_equal(ranks[i * m + j]["logits"][-1],
                                          ranks[i * m]["logits"][-1])
    assert all(r["pos"] == int(ref["pos"]) for r in ranks)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_the_assembled_cache_matches_the_reference(run, case):
    ref = run["ref"][ref_key(case)]
    ranks = _ranks(run, case)
    for tag in ("cache0", "cache"):
        got = _assembled(case, [r[tag] for r in ranks])
        want = {k.split("/", 1)[1]: v for k, v in ref.items()
                if k.startswith(tag + "/")}
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in got:
            _close(got[k], want[k], STATE_TOL, f"{tag} {k}")


def _as_port(entry):
    return tuple(entry) if isinstance(entry, list) else entry


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_each_rank_holds_the_reference_s_cache_slice(run, case):
    """The port's cache specs are the reference's ``cache_shardings`` on
    the same mesh (an SSM state's ``(data, model)`` where the rows do not
    go over ``dp`` would be ``model`` here: no case has one), and each
    rank's block is that slice of the reference's cache; Mamba2's conv
    buffer block is ``[x_r | B | C]`` of it."""
    cfg, cache, _, port = _port_specs(case)
    want = run["specs"][case_id(case)]
    assert set(port) == {k if "." in k else k + ".0" for k in want}
    mesh = small_mesh(*case[1])
    ref = run["ref"][ref_key(case)]
    for name, spec in port.items():
        rs = want.get(name, want.get(name.split(".")[0]))
        rs = tuple(_as_port(e) for e in rs) + (None,) * (len(spec) - len(rs))
        assert spec == rs, (name, spec, rs)
        whole = torch.from_numpy(ref[f"cache/{name}"])
        for rank, r in enumerate(_ranks(run, case)):
            block = r["cache"][name]
            if cfg.ssm_version == 2 and name.endswith(".0") and \
                    spec[-1] is not None and "ssm" in name:
                w = cfg.d_inner // mesh.axis_size(("model",))
                j = mesh.axis_index(("model",), rank)
                rows = NamedSharding(mesh, spec[:-1] + (None,)).shard(
                    whole, rank)
                cut = torch.cat([rows[..., j * w:(j + 1) * w],
                                 rows[..., cfg.d_inner:]], dim=-1)
            else:
                cut = NamedSharding(mesh, spec).shard(whole, rank)
            _close(block, cut.numpy(), STATE_TOL, f"{name} rank {rank}")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cache_shardings_cut_the_reference_s_cache_into_the_blocks(run,
                                                                   case):
    """Applied to the reference's whole cache, each leaf's sharding from
    :func:`cache_shardings` gives every rank's block (a Mamba2 conv
    buffer's a :class:`FusedSharding`: ``[x_r | B | C]``), and its
    ``assemble`` of the blocks gives the whole back, for anyone who lays
    out a cache through the shardings rather than the steps."""
    _, _, shardings = _shardings(case)
    ref = run["ref"][ref_key(case)]
    ranks = _ranks(run, case)
    for name, sh in shardings.items():
        whole = torch.from_numpy(ref[f"cache/{name}"])
        blocks = [sh.shard(whole, rank) for rank in range(len(ranks))]
        for rank, (b, r) in enumerate(zip(blocks, ranks)):
            assert tuple(b.shape) == sh.local_shape(whole.shape), name
            _close(r["cache"][name], b.numpy(), STATE_TOL,
                   f"{name} rank {rank}")
        np.testing.assert_array_equal(sh.assemble(blocks).numpy(),
                                      whole.numpy())


def _dry(case, rank, kind, mesh=None):
    arch, shape, B, over = case
    m = small_mesh(*(mesh or shape))
    cost = StepCost()
    ctx = make_ctx(m, DryMeshGroup(m, rank, cost))
    cfg = cfg_of(arch, over)
    pshape, dshape = shapes_of(case)
    if kind == "prefill":
        step, args, _ = make_prefill_step(cfg, ctx, pshape,
                                          max_len=max_len_of(cfg))
    else:
        step, args, _ = make_decode_step(cfg, ctx, dshape)
    analyze_step(step, *args, cost=cost)
    return ctx.group.counters(), cost


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_dry_run_predicts_each_rank_s_collectives(run, case):
    for rank, r in enumerate(_ranks(run, case)):
        assert _dry(case, rank, "prefill")[0] == r["counters"]["prefill"], \
            rank
        want = _dry(case, rank, "decode")[0]
        assert all(c == want for c in r["counters"]["decode"]), rank


def _kv_repeat(cfg, rows, tp):
    """The FLOPs of the KV projections a rank forms beyond its 1/tp share
    where tp does not divide the KV heads of partitioned attention
    (forward only)."""
    if cfg.num_kv_heads % tp == 0 or "attn" in tp_whole(cfg, tp):
        return 0.0
    share = 2 * cfg.num_kv_heads * cfg.hd / tp
    return 2.0 * rows * cfg.d_model * (2 * cfg.hd - share) * cfg.num_layers


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("case", [c for c in CASES if c[1][1] > 1],
                         ids=case_id)
def test_a_rank_s_flops_are_its_share_and_the_whole_work(case, kind):
    """Against the same rows on the mesh without the model axis: exactly
    ``(F1 - R) / tp + R`` (:func:`replicated_flops`: a MoE layer's
    router, Mamba2's B and C, whole attention's projections), and where 4
    does not divide the 2 KV heads the KV head each rank projects on
    top."""
    arch, (d, m), B, over = case
    cfg = cfg_of(arch, over)
    rows = B // d if B > 1 and B % d == 0 else B
    one = _dry(case, 0, kind, mesh=(d, 1))[1].flops
    R = replicated_flops(cfg, rows, S, m, kind)
    tokens = rows * (cfg.frontend_tokens * (cfg.frontend != "none") + S) \
        if kind == "prefill" else rows
    want = (one - R) / m + R + _kv_repeat(cfg, tokens, m)
    for rank in range(d * m):
        assert _dry(case, rank, kind)[1].flops == want, (rank, want)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == (1, 2)],
                         ids=case_id)
def test_one_by_two_gathers_no_leaf(run, case):
    """(1, 2): every leaf is this rank's block or replicated, so the only
    all-gathers are of activations: the prefill's logits, and in a decode
    step each attention layer's q, k, v and the logits (zamba2: its
    shared block's ``fused_proj`` output too)."""
    cfg = cfg_of(case[0], case[3])
    L = cfg.num_layers
    n_attn = 0 if cfg.attention_free else (
        L // cfg.hybrid_attn_every if cfg.hybrid_attn_every else L)
    fused = n_attn if cfg.hybrid_attn_every else 0
    for r in _ranks(run, case):
        pre, dec = r["counters"]["prefill"], r["counters"]["decode"][0]
        assert pre["calls"]["all_gather"] == 1 + fused, pre
        assert dec["calls"]["all_gather"] == 1 + n_attn + fused, dec
        assert "reduce_scatter" not in dec["calls"]


def test_moe_prefill_routes_over_the_global_batch(run):
    """qwen2-moe on (2, 1) with tokens dropped: the two ranks' prefill
    logits, concatenated, are the reference's ``lm.prefill`` on the whole
    batch (each rank routing its own rows would keep other tokens), and
    the ranks exchange their per-expert counts once a layer."""
    case = next(c for c in CASES if c[0] == "qwen2-moe-a2.7b"
                and c[1] == (2, 1))
    ranks = _ranks(run, case)
    got = np.concatenate([r["prefill_logits"] for r in ranks])
    _close(got, run["ref"][ref_key(case)]["prefill_logits"], LOGIT_TOL,
           "moe prefill logits")
    cfg = cfg_of(case[0], case[3])
    for r in ranks:
        calls = r["counters"]["prefill"]["calls"]
        # the weights' fsdp gathers, and one count exchange a MoE layer
        assert calls["all_gather"] >= cfg.num_layers, calls


def test_a_cache_the_sequence_ranks_do_not_divide_is_refused():
    """As the train step refuses rows that do not split: a cache length
    the sequence-parallel ranks do not divide raises at the step's
    construction (4 model ranks, 30 positions; one row on (2, 2): 4
    ranks of (data, model))."""
    cfg = cfg_of("stablelm-1.6b")
    for mesh, B in (((1, 4), 2), ((2, 2), 1)):
        m = small_mesh(*mesh)
        ctx = make_ctx(m, DryMeshGroup(m, 0))
        with pytest.raises(ValueError, match="does not split"):
            make_decode_step(cfg, ctx, ShapeSpec("d", 30, B, "decode"))
        with pytest.raises(ValueError, match="does not split"):
            make_prefill_step(cfg, ctx, ShapeSpec("p", S, B, "prefill"),
                              max_len=30)

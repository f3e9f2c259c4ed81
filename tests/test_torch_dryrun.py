"""The port's dry run on the CPU: ``repro_torch.distributed.op_analysis``
(the counterpart of ``repro.distributed.hlo_analysis``), the step
factories of ``repro_torch.train.train_step`` and
``repro_torch.launch.dryrun``.

* The programs with known costs of ``tests/test_hlo_analysis.py``, as
  Python loops on meta tensors: their FLOPs are exact (a loop runs every
  trip), a data-dependent loop on CPU data counts the trips it ran, and the
  collective stand-in sizes each type as the reference's analyzer does.
* The prefill step of stablelm-1.6b's and qwen2-moe-a2.7b's smoke configs:
  the port's matmul FLOPs equal the reference's ``analyze_hlo(...).flops``
  of the same step compiled on the CPU on one device (held within 1%;
  both count ``2 * M * N * K`` per product and no gap was found).
* A rank's argument bytes under the rule table, for every arch on a (2, 1)
  and a (1, 2) mesh, equal the bytes of the blocks ``reshard_state`` keeps
  on that rank of the live fp32 masters and AdamW moments, plus the batch.
* The dry-run CLI writes a record with the reference's keys (``fits_80gb``
  for ``fits_16gb``) and the H100 constants, allocating nothing on a
  device.

The collective counters of a dry-run train step are held to a live 2-rank
step's in ``tests/test_torch_train_mesh.py``, on its spawned group.
"""
import dataclasses
import json

import jax
import pytest
import torch

from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.distributed.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_ctx as jmake_ctx
from repro.train.train_step import make_prefill_step as jmake_prefill_step
from repro_torch.configs import ARCHS, ShapeSpec, get_config
from repro_torch.distributed.op_analysis import (DryMeshGroup, DryTPGroup,
                                                 StepCost, analyze_step)
from repro_torch.distributed.sharding import Mesh, ShardCtx, gather_tp
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_ctx, small_mesh
from repro_torch.optim import init_opt_state
from repro_torch.params import init_params
from repro_torch.train.elastic import reshard_state
from repro_torch.train.train_step import (make_decode_step,
                                          make_prefill_step,
                                          train_input_specs)
from repro_torch.tree import leaves

META = torch.device("meta")


def _meta(*shape):
    return torch.zeros(shape, device=META)


# ------------------------------------------- known programs (exact)
def test_looped_flops_are_multiplied_by_the_trips():
    x, w = _meta(128, 128), _meta(8, 128, 128)

    def looped(x, w):
        for i in range(8):
            x = x @ w[i]
        return x

    cost = analyze_step(looped, x, w)
    assert cost.flops == 8 * 2 * 128 ** 3
    assert cost.unknown_trip_loops == 0


def test_unrolled_equals_looped():
    x, w = _meta(128, 128), _meta(4, 128, 128)

    def unrolled(x, w):
        return x @ w[0] @ w[1] @ w[2] @ w[3]

    def looped(x, w):
        for wi in w.unbind(0):
            x = torch.matmul(x, wi)
        return x

    cu, cl = analyze_step(unrolled, x, w), analyze_step(looped, x, w)
    assert cu.flops == cl.flops == 4 * 2 * 128 ** 3


def test_nested_loops_multiply():
    x, w = _meta(64, 64), _meta(3, 64, 64)

    def fn(x, w):
        for _ in range(5):
            for i in range(3):
                x = x @ w[i]
        return x

    assert analyze_step(fn, x, w).flops == 5 * 3 * 2 * 64 ** 3


@pytest.mark.parametrize("limit,trips", [(1.0, 1), (1e5, 2), (1e9, 3)])
def test_data_dependent_loop_counts_the_trips_it_ran(limit, trips):
    """On CPU data the loop's exit is decided by values (a 64 x 64 matrix
    of halves squared t times sums 4096 * e_t, e_1 = 16, e_2 = 16384,
    e_3 = 1.7e10), and exactly the trips it ran are counted."""
    m0 = torch.full((64, 64), 0.5)

    def fn(m):
        n = 0
        while n == 0 or (float(m.sum()) < limit and n < 6):
            m = m @ m
            n += 1
        return m

    assert analyze_step(fn, m0).flops == trips * 2 * 64 ** 3


def test_batched_products_and_einsum_count_2mnk():
    a, b = _meta(3, 16, 32), _meta(3, 32, 8)
    assert analyze_step(torch.bmm, a, b).flops == 2 * 3 * 16 * 32 * 8
    assert analyze_step(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                        a, b).flops == 2 * 3 * 16 * 32 * 8
    lin = torch.nn.functional.linear
    assert analyze_step(lin, _meta(5, 32), _meta(16, 32),
                        _meta(16)).flops == 2 * 5 * 32 * 16


def test_depthwise_convolution_counts_as_the_reference():
    """The reference counts ``2 * numel(result) * numel(kernel) /
    max(kernel dims)``: a depthwise (C, 1, K) kernel gives 2 * out * K."""
    x, w = _meta(2, 16, 40), _meta(16, 1, 4)
    cost = analyze_step(lambda x, w: torch.nn.functional.conv1d(
        x, w, groups=16), x, w)
    assert cost.flops == 2 * (2 * 16 * 37) * 4


def test_collective_standin_sizes_each_type_as_the_reference():
    """f32[64,128] gathered over 4 ranks is 128 KiB; the reduce-scatter of
    the gathered tensor and the all-reduce count their 128 KiB operand;
    the counters are the live group's."""
    cost = StepCost()
    g = DryMeshGroup(small_mesh(4, 1), 0, cost)
    x = _meta(64, 128)

    def fn(x):
        full = g.all_gather(x, ("data",), 0)
        red = g.all_reduce(full, ("data",))
        return g.reduce_scatter(red, ("data",), 0)

    out = analyze_step(fn, x, cost=cost)
    assert tuple(fn(x).shape) == (64, 128)
    kib = 1024.0
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert out.collective_bytes[kind] == 2 * 128 * kib   # fn ran twice
        assert out.collective_counts[kind] == 2
        assert out.collective_max_bytes[kind] == 128 * kib
    assert out.collective_bytes["all-to-all"] == 0.0
    assert g.counters()["calls"] == {"all_gather": 2, "all_reduce_sum": 2,
                                     "reduce_scatter": 2}
    assert out.link_bytes["internode"] == 0.0


def test_tp_standin_gathers_heads_in_rank_order_shapes():
    cost = StepCost()
    tp = DryTPGroup(0, 2, cost)

    def fn(x):
        with tp.active("probe"):
            return gather_tp(x, dim=3)

    got = analyze_step(fn, _meta(2, 2, 3, 4, 8, 16), cost=cost)
    assert got.collective_counts["all-gather"] == 1
    assert tp.counters()["calls"] == {"all_gather": 1,
                                      "all_gather:probe": 1}


def test_peak_counts_live_storage_and_frees_the_dead():
    """Arguments live throughout; a temporary that dies before the next
    one is born does not add to it."""
    x = _meta(256, 256)                          # 256 KiB

    def fn(x):
        y = x * 2                                # +256 KiB
        z = y + 1                                # +256 KiB (y alive)
        del y
        return z.sum()

    cost = analyze_step(fn, x)
    assert cost.argument_bytes == 256 * 1024
    assert cost.peak_bytes == 3 * 256 * 1024
    assert cost.temp_bytes == 2 * 256 * 1024


# -------------------------------------- the reference's analyzer, FLOPs
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("seq", [64, 256])
def test_prefill_flops_equal_the_reference_hlo_analysis(arch, seq):
    """Within 2% required; held to 1%: the matmul FLOPs are equal (no gap
    to name)."""
    step, specs, _ = jmake_prefill_step(jget_config(arch).smoke(),
                                        jmake_ctx(None),
                                        JShape("p", seq, 2, "prefill"))
    want = analyze_hlo(jax.jit(step).lower(*specs).compile().as_text())
    tstep, args, _ = make_prefill_step(get_config(arch).smoke(),
                                       ShardCtx(mesh=None),
                                       ShapeSpec("p", seq, 2, "prefill"))
    got = analyze_step(tstep, *args)
    assert abs(got.flops - want.flops) <= 0.01 * want.flops, \
        (got.flops, want.flops)
    assert got.flops == want.flops


# ----------------------------------------- argument bytes vs live blocks
def _bytes(tree):
    return sum(t.numel() * t.element_size() for t in leaves(tree))


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_each_rank_s_live_blocks(arch, mesh):
    cfg = get_config(arch).smoke()
    shape = ShapeSpec("t", 16, 4, "train")
    full = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       cast=False)
    m = small_mesh(*mesh)
    for rank in range(m.size):
        ctx = make_ctx(m, DryMeshGroup(m, rank))
        _, args, _ = train_input_specs(cfg, ctx, shape)
        dry = analyze_step(lambda *a: None, *args).argument_bytes
        live = reshard_state(cfg, {"params": full}, ctx, rank=rank,
                             device="cpu")["params"]
        opt = init_opt_state(live, dryrun.OptConfig())
        batch = 4 * 16 * 4 + (4 * cfg.frontend_tokens * cfg.d_model * 2
                              if cfg.frontend != "none" else 0)
        assert dry == _bytes(live) + _bytes(opt) + batch, (arch, rank)
        assert _bytes(live) < _bytes(full) or mesh == (1, 2)


def test_decode_and_prefill_steps_run_on_a_mesh_of_meta_ranks():
    """The serve steps under a (2, 1) mesh: each rank's dp rows, weights
    gathered through the stand-in (one all-gather per sharded leaf)."""
    cfg = get_config("stablelm-1.6b").smoke()
    m = small_mesh(2, 1)
    shape = ShapeSpec("d", 64, 4, "decode")
    cost = StepCost()
    ctx = make_ctx(m, DryMeshGroup(m, 1, cost))
    step, (p, cache, tok), _ = make_decode_step(cfg, ctx, shape)
    assert cache["k"].shape[1] == 2 and tok.shape == (4,)
    logits = step(p, cache, tok)[0]
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    assert ctx.group.counters()["calls"]["all_gather"] > 0
    step, (p, b), _ = make_prefill_step(cfg, ctx, ShapeSpec("p", 32, 4,
                                                            "prefill"))
    assert analyze_step(step, p, b).flops > 0


# --------------------------------------------------------- the CLI
def test_cli_writes_a_record_with_the_reference_keys(tmp_path):
    out = tmp_path / "dryrun.jsonl"
    before = torch.cuda.is_initialized()
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k",
                        "--mesh", "node", "--out", str(out)]) == 0
    assert torch.cuda.is_initialized() == before
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert {"arch", "shape", "mesh", "chips", "kind", "tag", "ok",
            "lower_s", "compile_s", "memory", "flops_per_dev",
            "bytes_per_dev", "flops_per_dev_rawca", "bytes_per_dev_rawca",
            "unknown_trip_loops", "collective_bytes", "collective_counts",
            "collective_bytes_total", "roofline"} <= set(rec)
    assert {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
            "fits_80gb"} <= set(rec["memory"])
    assert {"compute_s", "memory_s", "collective_s", "dominant",
            "step_lower_bound_s", "model_flops_global",
            "model_flops_per_dev", "useful_flops_frac",
            "roofline_frac"} <= set(rec["roofline"])
    assert rec["chips"] == 8 and rec["mesh"] == "8x1" and rec["ok"]
    assert "H100" in rec["card"] and "700 W" in rec["card"]
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    # one decode token against a 32k cache: 2 * N_active per token, the
    # whole KV cache of the card's 16 rows in its arguments
    cfg = get_config("stablelm-1.6b")
    kv = 2 * cfg.num_layers * 16 * cfg.num_kv_heads * 32768 * cfg.hd * 2
    assert rec["memory"]["argument_bytes"] >= kv
    assert rec["memory"]["fits_80gb"] == (rec["memory"]["peak_bytes"]
                                          < 80e9)


def test_opt_variant_as_the_reference():
    from repro.launch.dryrun import apply_variant as japply
    for arch in ARCHS:
        got = dryrun.apply_variant(get_config(arch), "opt")
        want = japply(jget_config(arch), "opt")
        for f in ("attn_bwd_remat", "hoist_weight_gather",
                  "ssm_scan_constrain", "moe_expert_pad"):
            assert getattr(got, f) == getattr(want, f), (arch, f)
    assert dryrun.apply_variant(get_config("stablelm-1.6b"), "") == \
        get_config("stablelm-1.6b")


def test_every_applicable_cell_is_listed_for_both_meshes():
    cells = list(dryrun.cells(ARCHS, ["train_4k", "long_500k"],
                              ["node", "multi"]))
    skipped = {(a, s) for a, s, m, _ in cells if m is None}
    assert ("stablelm-1.6b", "long_500k") in skipped
    assert ("falcon-mamba-7b", "long_500k") not in skipped
    assert sum(m is not None for _, _, m, _ in cells) == \
        2 * (len(ARCHS) + len(ARCHS) - len(skipped))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "internvl2-1b"])
def test_node_tp_runs_the_hybrid_and_the_fourteen_head_train_cells(arch):
    """On ``node_tp`` (2 x 4) zamba2's and internvl2's train cells run
    (and, since the serve steps partition too, their prefill cells), and
    a rank's
    dry step at smoke width (internvl2 with its 14 query heads) counts the
    partitioned step's collectives: zamba2's fused Mamba2 leaves one
    all-to-all a fetch and one a reduction, its shared block's
    ``fused_proj`` output gathered (twice a group with remat); internvl2's
    attention leaves gathered whole once a microbatch; every rank makes
    the same calls (a rank's all-to-all bytes follow the parts its block
    holds)."""
    cells = list(dryrun.cells([arch], ["train_4k", "prefill_32k"],
                              ["node_tp"]))
    assert (arch, "train_4k", "node_tp", "") in cells
    assert (arch, "prefill_32k", "node_tp", "") in cells
    cfg = get_config(arch).smoke()
    if arch == "internvl2-1b":
        cfg = dataclasses.replace(cfg, num_heads=14)
    mesh = Mesh(*dryrun.MESHES["node_tp"][:2])
    shape, mb = ShapeSpec("t", 32, 8, "train"), 2
    seen = []
    for rank in range(mesh.size):
        ctx = make_ctx(mesh, DryMeshGroup(mesh, rank, StepCost()))
        step, args, _ = train_input_specs(cfg, ctx, shape, microbatches=mb)
        analyze_step(step, *args, cost=ctx.group.cost)
        seen.append(ctx.group.counters())
    assert all(c["calls"] == seen[0]["calls"] for c in seen)
    calls = seen[0]["calls"]
    if arch == "zamba2-1.2b":
        G = cfg.num_layers // cfg.hybrid_attn_every
        # in_proj, conv_w, conv_b of the group's and the tail's stacks
        assert calls["all_to_all"] == 6 * (mb + 1)
        assert seen[0]["max_bytes"]["all_gather"] >= \
            shape.global_batch // 2 // mb * shape.seq_len * cfg.d_model * 4
        assert calls["all_gather"] >= 2 * G * mb
    else:
        # wq wk wv wo bq bk bv, one stacked leaf each, over model and data
        assert calls["all_gather"] >= 7 * mb
        assert "all_to_all" not in calls


SERVE = ["prefill_32k", "decode_32k", "long_500k"]


def test_node_tp_lists_and_runs_every_serve_cell():
    """Every applicable serve cell runs on ``node_tp`` (only the pure
    attention archs' ``long_500k`` is skipped, as on every mesh), and a
    rank's KV cache argument is its rows' whole cache over the sequence
    axes: stablelm-1.6b's ``decode_32k`` 64 rows a rank at 1/4 of the
    positions, zamba2-1.2b's ``long_500k`` one row at 1/8 (``(data,
    model)``)."""
    cells = list(dryrun.cells(ARCHS, SERVE, ["node_tp"]))
    for arch, shape, m, why in cells:
        ok, _ = dryrun.shape_applicable(get_config(arch),
                                        dryrun.SHAPES_BY_NAME[shape])
        assert (m == "node_tp") == ok, (arch, shape, why)
    assert sum(m is not None for *_, m, _ in cells) == 2 * len(ARCHS) + 2
    cfg, _, _, _, _, args = dryrun.build_cell("zamba2-1.2b", "long_500k",
                                              "node_tp")
    G = cfg.num_layers // cfg.hybrid_attn_every
    whole = G * 1 * cfg.num_kv_heads * 524288 * cfg.hd
    assert args[1]["shared_k"].numel() == whole // 8
    cfg, _, _, _, _, args = dryrun.build_cell("stablelm-1.6b", "decode_32k",
                                              "node_tp")
    whole = cfg.num_layers * 64 * cfg.num_kv_heads * 32768 * cfg.hd
    assert args[1]["k"].numel() == args[1]["v"].numel() == whole // 4
    rec = dryrun.run_cell("stablelm-1.6b", "decode_32k", "node_tp")
    assert rec["ok"] and rec["chips"] == 8 and rec["mesh"] == "2x4"
    # the weights' blocks, the bf16 K and V blocks and the int32 tokens
    assert rec["memory"]["argument_bytes"] == rec["memory"]["param_bytes"] \
        + 2 * 2 * whole // 4 + 128 * 4


def test_multi_tp_is_four_nodes_with_a_model_axis():
    """``multi_tp``: ``pod`` 4 x ``data`` 2 x ``model`` 4, 32 cards, a node
    being ``data x model``. A serve cell's ``fsdp`` gathers (over ``(pod,
    data)``) cross nodes; its ``tp`` and sequence-parallel collectives
    (``model``) stay inside a node."""
    assert dryrun.MESHES["multi_tp"] == ((4, 2, 4), ("pod", "data", "model"),
                                         "4x2x4")
    cells = list(dryrun.cells(["stablelm-1.6b", "zamba2-1.2b"], SERVE,
                              ["multi_tp"]))
    assert sum(m is not None for *_, m, _ in cells) == 5
    cfg = get_config("stablelm-1.6b").smoke()
    mesh = Mesh(*dryrun.MESHES["multi_tp"][:2])
    cost = StepCost()
    ctx = make_ctx(mesh, DryMeshGroup(mesh, 5, cost))
    step, args, _ = make_decode_step(cfg, ctx, ShapeSpec("d", 64, 16,
                                                         "decode"))
    analyze_step(step, *args, cost=cost)
    assert cost.link_bytes["internode"] > 0 and cost.link_bytes["nvlink"] > 0
    # 16 rows over the 8 dp ranks, 64 positions over the 4 model ranks
    assert tuple(args[1]["k"].shape[1:4]) == (2, cfg.num_kv_heads, 16)

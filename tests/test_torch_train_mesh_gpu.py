"""Sharded training on the card: two ``gloo`` ranks on ``cuda:0`` (this
process and one spawned rank, a (2, 1) mesh, and a (1, 2) mesh whose step
partitions its products over the model axis) against the single-device
step, at smoke size.

* Every collective the sharded step uses (tiled all-gathers over a mesh
  axis, the reduce-scatter, sum and max all-reduces, the barrier) on CUDA
  tensors, with the values checked: ``gloo`` takes each of them on the
  card (staging through host memory itself), so ``MeshGroup`` copies
  nothing.
* The fp32 step (TF32 off, 4 layers of the smoke width, 2 x 64, two
  microbatches, hoisted and not) against the single-device step on the
  card, within ``tests/test_torch_train_mesh.py``'s tolerances; each
  rank's bytes are what its specs give.
* falcon-mamba-7b's smoke config: K3 and its backward launch on both
  ranks under the group.
* (1, 2): stablelm's fp32 step and falcon-mamba's (K3 and its backward on
  each rank's dI / 2 channels, ``in_proj`` exchanged) against the
  single-device step; no leaf is all-gathered.
* (1, 2), the ``moe-tp`` run of ``chip_smoke.py`` at smoke size:
  qwen2-moe's fp32 step with 4 of its 8 experts a rank, each rank's blocks
  against the same blocks of the single-device step, which each rank runs
  on the card in turn; no leaf is all-gathered.
* (1, 2), the ``zamba2-tp`` run of ``chip_smoke.py`` at smoke size:
  zamba2's fp32 step on each rank's SSD heads, each rank's blocks against
  one device's; only the shared block's ``fused_proj`` output (an
  activation) is all-gathered.

They carry the ``gpu`` marker and skip without CUDA:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_mesh_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.bench.train_mesh import (Runs, TrainRun, compare_states,
                                          single_run)
from repro_torch.launch.mesh import MeshSession, mesh_ctx, small_mesh

pytestmark = pytest.mark.gpu
FP32 = (("compute_dtype", "float32"), ("num_layers", 4))
RUNS = (TrainRun("fp32", preset="smoke", overrides=FP32, batch=4, seq=64,
                 microbatches=2, keep=True),
        TrainRun("fp32-hoist", preset="smoke", overrides=FP32 + (
            ("hoist_weight_gather", True),), batch=4, seq=64,
            microbatches=2, keep=True),
        TrainRun("falcon", "falcon-mamba-7b", "smoke", batch=2, seq=64),
        TrainRun("fp32-tp", preset="smoke", overrides=FP32, batch=4,
                 seq=64, microbatches=2, mesh=(1, 2), keep=True),
        TrainRun("falcon-tp", "falcon-mamba-7b", "smoke", overrides=FP32,
                 batch=2, seq=64, microbatches=2, mesh=(1, 2), keep=True),
        TrainRun("moe-tp", "qwen2-moe-a2.7b", "smoke", overrides=FP32,
                 batch=4, seq=64, microbatches=1, mesh=(1, 2),
                 vs_single=True),
        TrainRun("zamba2-tp", "zamba2-1.2b", "smoke", overrides=(
            ("compute_dtype", "float32"),), batch=2, seq=64,
            microbatches=1, mesh=(1, 2), vs_single=True))
#: the (1, 2) runs, each held against the single-device step of RUNS[i]
TP = {3: 0, 4: 4}


@dataclasses.dataclass(frozen=True)
class Collectives:
    """Each collective of ``MeshGroup`` once on CUDA tensors, its result
    checked on every rank."""

    def __call__(self, dev):
        import torch.distributed as dist
        ctx = mesh_ctx(small_mesh(2, 1), dev, timeout_s=60.0)
        g, r = ctx.group, dist.get_rank()
        x = torch.arange(8, dtype=torch.float32, device=dev).reshape(2, 4) \
            + 10 * r
        got = {}
        full = g.all_gather(x, ("data",), 1)
        got["all_gather"] = torch.equal(full[:, 4:], x - 10 * r + 10) \
            and full.shape == (2, 8)
        rs = g.reduce_scatter(x, ("data",), 0)
        got["reduce_scatter"] = torch.equal(
            rs, (2 * torch.arange(8, device=dev).reshape(2, 4) + 10)[r:r + 1]
            .float())
        s = g.all_reduce(x.clone())
        got["all_reduce_sum"] = float(s[0, 0]) == 10.0
        m = g.all_reduce(x.clone(), op="max")
        got["all_reduce_max"] = float(m[0, 0]) == 10.0
        g.barrier()
        got["barrier"] = True
        got["devices"] = {str(t.device) for t in (full, rs, s, m)}
        return got


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3 has no CPU mode)")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    with MeshSession(2, "gloo", Collectives(), dev, timeout=300.0,
                     op_timeout_s=120.0) as s:
        s.run()
    coll = s.results
    with MeshSession(2, "gloo", Runs(RUNS), dev, timeout=600.0,
                     op_timeout_s=300.0) as s:
        s.run()
    return {"collectives": coll, "ranks": s.results,
            "single": {i: single_run(RUNS[i], dev) for i in (0, 1, 4)}}


def test_gloo_takes_every_collective_on_cuda_tensors(card):
    for got in card["collectives"]:
        assert got.pop("devices") == {"cuda:0"}
        assert all(got.values()), got


@pytest.mark.parametrize("i", [0, 1], ids=["unhoisted", "hoisted"])
def test_fp32_step_matches_the_single_device_step(card, i):
    got = card["ranks"][0][i]
    one = card["single"][i]
    cmp = compare_states(got["whole"], one["whole"], got["history"],
                         one["history"], RUNS[i].lr)
    if i == 0:
        assert cmp["metric_rel"] <= 1e-5 and cmp["m_rel"] <= 1e-5 \
            and cmp["v_rel"] <= 1e-5 and cmp["param_lr"] <= 5e-2, cmp
    else:   # bf16 gathered weights against fp32 ones
        assert cmp["metric_rel"] <= 5e-4, cmp
    assert cmp["ill_param_lr"] <= 2.05, cmp


@pytest.mark.parametrize("i", sorted(TP), ids=["fp32-tp", "falcon-tp"])
def test_partitioned_step_matches_the_single_device_step(card, i):
    got = card["ranks"][0][i]
    one = card["single"][TP[i]]
    cmp = compare_states(got["whole"], one["whole"], got["history"],
                         one["history"], RUNS[i].lr)
    assert cmp["metric_rel"] <= 1e-5 and cmp["m_rel"] <= 1e-5 \
        and cmp["v_rel"] <= 1e-5 and cmp["param_lr"] <= 5e-2, cmp
    assert cmp["ill_param_lr"] <= 2.05, cmp
    for rank in card["ranks"]:
        assert "all_gather" not in rank[i]["counters"]["calls"]


def test_moe_partitioned_step_matches_the_single_device_step(card):
    """Each rank's blocks (its experts, its shared experts' slices, the
    router whole) against the same blocks of one device's step."""
    for rank in card["ranks"]:
        r = rank[5]
        cmp = r["vs_single"]
        assert cmp["metric_rel"] <= 1e-5 and cmp["m_rel"] <= 1e-5 \
            and cmp["v_rel"] <= 1e-5 and cmp["param_lr"] <= 5e-2, cmp
        assert cmp["ill_param_lr"] <= 2.05, cmp
        assert "all_gather" not in r["counters"]["calls"]
        experts = [b[1] for (full, _), b in zip(r["leaf_shapes_specs"],
                                                r["block_shapes"])
                   if len(full) == 4 and full[1] == 8]
        assert experts == [4, 4, 4], experts


def test_zamba2_partitioned_step_matches_the_single_device_step(card):
    """Each rank's blocks (its SSD heads, its blocks of the fused leaves,
    the shared block's column and row blocks) against the same blocks of
    one device's step; the (1, 2) step gathers the shared block's input
    projection, once in the forward and once in remat's recompute, and
    no leaf."""
    for rank in card["ranks"]:
        r = rank[6]
        cmp = r["vs_single"]
        assert cmp["metric_rel"] <= 1e-5 and cmp["m_rel"] <= 1e-5 \
            and cmp["v_rel"] <= 1e-5 and cmp["param_lr"] <= 5e-2, cmp
        assert cmp["ill_param_lr"] <= 2.05, cmp
        calls, most = r["counters"]["calls"], r["counters"]["max_bytes"]
        assert calls["all_gather"] == 2, calls
        assert most["all_gather"] == 2 * 64 * 64 * 4, most
        assert calls["all_to_all"] == 12, calls


@pytest.mark.parametrize("i", [0, 1, 2, 3, 4, 5, 6])
def test_each_rank_holds_its_specs_bytes(card, i):
    for rank in card["ranks"]:
        r = rank[i]
        assert r["param_bytes"] == r["spec_bytes"] < r["full_bytes"]
        assert r["moment_bytes"] == 2 * r["spec_bytes"]


def test_k3_and_its_backward_launch_on_both_ranks(card):
    for rank in card["ranks"]:
        launches = rank[2]["launches"]
        assert launches["mamba_scan"] > 0, launches
        assert launches["mamba_scan_bwd"] > 0, launches


def test_k3_and_its_backward_launch_on_both_ranks_of_the_partitioned_step(
        card):
    for rank in card["ranks"]:
        launches = rank[4]["launches"]
        assert launches["mamba_scan"] > 0, launches
        assert launches["mamba_scan_bwd"] > 0, launches

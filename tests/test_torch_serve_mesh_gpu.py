"""Tensor-parallel serving on the card: two ``gloo`` ranks on ``cuda:0``
(this process and one spawned follower) against the single-device engine.

The matrix of ``tests/test_torch_serve_mesh.py`` (sync and async decode,
prefix cache off and on, chunked prefill, block growth, a copy-on-write
fork) on the fp32 smoke config with TF32 off: tokens equal the
single-device engine's (whose chunk is a captured CUDA graph; the 2-rank
engine's runs eagerly), each rank's pool is half the single pool, no
all-reduce, and both ranks launch K1 and K2 on their heads. They carry the
``gpu`` marker and skip without CUDA:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_mesh_gpu.py
"""
import pytest
import torch

from repro_torch.bench.serve_mesh import MATRIX, parity_matrix, parity_prompts
from repro_torch.kernels import ops
from repro_torch.launch.mesh import ModelSpec, TPSession

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
    with TPSession(2, "gloo", SPEC, dev, timeout=300.0) as s:
        before = ops.launch_counts()
        res = parity_matrix(s.tp, cfg, params, prompts, 12, dev)
        after = ops.launch_counts()
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
    for launches in [mesh["rank0_launches"]] + [
            e["launches"] for e in mesh["follower"]["result"]]:
        assert launches["paged_attention"] > 0
        assert launches["flash_attention"] > 0
    for run in mesh["cases"].values():
        assert run["counters"]["calls"].get("all_reduce", 0) == 0

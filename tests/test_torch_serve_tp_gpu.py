"""The partitioned prefill and decode steps on the card: two ``gloo``
ranks on ``cuda:0`` (this process and one spawned rank), at smoke size,
fp32, against one device on the same card.

* (1, 2): stablelm's prefill (K2 on each rank's heads) and greedy decode
  steps against a sequence-parallel cache, zamba2's (K2 in its shared
  block, Mamba2 on each rank's heads) and falcon-mamba's (K3 on each
  rank's channels): the tokens are one device's, the logits within
  ``LOGIT_TOL``, each rank's K/V half of one device's; rank 0 also
  against the plain path on one device, its block of the cache within
  ``STATE_TOL`` of max(1, |plain|).
* (2, 1) with one row: the cache's positions over both ranks, the decode
  on weights resident whole (``serve_tp_only``).

They carry the ``gpu`` marker and skip without CUDA:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_tp_gpu.py
"""
import pytest
import torch

from repro_torch.bench.train_mesh import Runs, ServeRun
from repro_torch.launch.mesh import MeshSession

pytestmark = pytest.mark.gpu
FP32 = (("compute_dtype", "float32"),)
LOGIT_TOL = 1e-4
STATE_TOL = 2e-5
RUNS = (ServeRun("stablelm", preset="smoke", overrides=FP32, batch=2,
                 prompt=48, max_len=64, steps=4),
        ServeRun("zamba2", "zamba2-1.2b", "smoke", FP32, batch=2, prompt=48,
                 max_len=64, steps=4),
        ServeRun("falcon", "falcon-mamba-7b", "smoke", FP32, batch=2,
                 prompt=48, max_len=64, steps=4),
        ServeRun("b1", preset="smoke", overrides=FP32, batch=1, prompt=48,
                 max_len=64, steps=4, mesh=(2, 1), serve_tp_only=True))


@pytest.fixture(scope="module")
def ranks():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with MeshSession(2, "gloo", Runs(RUNS), torch.device("cuda", 0)) as s:
        s.run()
    return s.results


@pytest.mark.parametrize("i", range(len(RUNS)), ids=[r.name for r in RUNS])
def test_two_ranks_agree_with_the_plain_path(ranks, i):
    """Rank 0's tokens, logits and block of the cache against one device's
    run through the plain path (no hand-written kernel): the one-device
    run above launches the same kernels as the ranks."""
    r0 = ranks[0][i]
    assert (r0["plain_tokens"] == r0["tokens"]).all()
    assert max(r0["plain_logits_max_abs"]) <= LOGIT_TOL
    assert r0["plain_cache_rel"] <= STATE_TOL


@pytest.mark.parametrize("i", range(len(RUNS)), ids=[r.name for r in RUNS])
def test_two_ranks_give_one_device_s_tokens(ranks, i):
    run, per = RUNS[i], [r[i] for r in ranks]
    cfg = run.config()
    r0 = per[0]
    assert (r0["single_tokens"] == r0["tokens"]).all()
    assert all((r["tokens"] == r0["tokens"]).all() for r in per)
    assert r0["logits_max_abs"] <= LOGIT_TOL
    if not cfg.attention_free:
        assert all(2 * r["kv_bytes"] == r0["single_kv_bytes"] for r in per)
    for r in per:
        if cfg.ssm and not cfg.hybrid_attn_every:
            assert r["launches"].get("mamba_scan", 0) == cfg.num_layers
        else:
            assert r["launches"].get("flash_attention", 0) > 0

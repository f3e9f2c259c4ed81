"""The port's ServeEngine on the MoE smoke configs (qwen2-moe: 8 experts
top-2 plus shared experts; arctic: 8 experts top-2 plus a dense residual)
against the reference engine.

Under float32 compute, with the reference's own weights, the port's engine
on the CPU and the JAX engine on its ``gather`` oracle path serve the
mixed-length prompts of ``tests/test_torch_serve.py`` on its geometry (a
prompt longer than ``prefill_chunk``, a pool tight enough to force block
growth and preemption) and must emit IDENTICAL greedy tokens and equal
``stats``, with every read path of the port (``loop``, ``gather``,
``kernel``, the last being K1's plain version on the CPU). The MoE
dispatch couples the rows of a batch (capacity is shared by all T = B*S
tokens, padded and inactive rows included), so equal tokens also say that
the port builds the same batches as the reference. The JAX tokens are
built once per arch.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.launch import serve as launcher
from repro_torch.params import from_reference
from repro_torch.serve.engine import ServeEngine

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
GEOM = dict(decode_chunk=4, prefill_chunk=16, max_batch=4, kv_blocks=20,
            block_size=4, max_admit=2)
LENS = (5, 9, 30, 3, 17, 12)
MAX_NEW = 14
STATS = ("admitted", "prefills", "prefill_windows", "tokens_out",
         "grown_blocks", "preempted", "retired")


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(cfg, the port's params, prompts, JAX tokens, JAX stats)."""
    cfg = dataclasses.replace(get_config(arch).smoke(),
                              compute_dtype="float32")
    jp = jax.jit(jlm.init_params, static_argnums=(0,))(
        cfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree_util.tree_map(np.asarray, jp), cfg,
                        device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
               for s in LENS]
    with JEngine(cfg, jp, paged_impl="gather", **GEOM) as eng:
        outs = [o.tolist() for o in eng.generate(prompts, max_new=MAX_NEW)]
        stats = dict(eng.stats)
    return cfg, tp, prompts, outs, stats


@pytest.mark.parametrize("impl", ["loop", "gather", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_and_stats_identical_to_jax_gather_engine(arch, impl):
    cfg, tp, prompts, ref, ref_stats = _reference(arch)
    with ServeEngine(cfg, tp, device="cpu", paged_impl=impl, **GEOM) as eng:
        assert eng.paged
        outs = [o.tolist() for o in eng.generate(prompts, max_new=MAX_NEW)]
        stats = dict(eng.stats)
        free = eng._pool.num_free
    for p, a, b in zip(prompts, outs, ref):
        assert a == b, f"prompt len {len(p)}"
    assert stats["prefill_windows"] > 0 and stats["grown_blocks"] > 0
    assert stats["preempted"] > 0
    for key in STATS:
        assert stats[key] == ref_stats[key], key
    assert free == GEOM["kv_blocks"] - 1


def test_launcher_serves_moe_on_cpu(capsys):
    launcher.main(["--arch", "qwen2-moe-a2.7b", "--device", "cpu",
                   "--batch", "2", "--prompt-len", "6", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "qwen2-moe-a2.7b-smoke" in out and "tok/s" in out
    assert "'retired': 2" in out

"""The column-slice single-device engine (``bench/serve_mesh.py::
column_slice_params``), which computes each product a tensor-parallel rank
holds a column slice of as the ranks do, on the CPU: its products are the
concatenated slice products bit for bit, its wrapper survives the model's
views and casts, and its engine's greedy tokens equal the single engine's
and the JAX engine's on the fp32 smoke config (where the slices change no
bit)."""
import numpy as np
import pytest
import torch

from repro_torch.bench.serve_mesh import (ColumnSlices, PARITY_KW,
                                          column_slice_params,
                                          parity_prompts, run_case)
from repro_torch.distributed import shard_serve_params
from repro_torch.launch.mesh import ModelSpec
from repro_torch.models import lm

CPU = torch.device("cpu")
SPEC = ModelSpec(overrides=(("compute_dtype", "float32"),))


@pytest.mark.parametrize("world", [2, 4])
def test_products_are_the_concatenated_slice_products(world):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 64, 96, generator=g, dtype=torch.bfloat16)
    x = torch.randn(5, 64, generator=g, dtype=torch.bfloat16)
    cls = type("CS", (ColumnSlices,), {"parts": world})
    wl = w.as_subclass(cls).unbind(0)[1].to(torch.bfloat16)
    assert isinstance(wl, ColumnSlices)
    got = x @ wl
    want = torch.cat([x @ s.contiguous() for s in
                      w[1].chunk(world, dim=-1)], dim=-1)
    assert type(got) is torch.Tensor and torch.equal(got, want)


def test_wrapped_leaves_are_the_ones_a_rank_cuts():
    cfg, params = SPEC(CPU)
    wrapped = column_slice_params(cfg, params, 2)
    shard = shard_serve_params(cfg, params, 0, 2)
    for name, t in wrapped["blocks"].items():
        cut = shard["blocks"][name].shape != params["blocks"][name].shape
        assert isinstance(t, ColumnSlices) == (cut and t.dim() >= 3), name
        assert t.data_ptr() == params["blocks"][name].data_ptr()


def test_engine_tokens_and_logits_equal_the_single_engine():
    cfg, params = SPEC(CPU)
    prompts = parity_prompts(cfg.vocab_size)
    want = run_case(cfg, params, prompts, 8, CPU, **PARITY_KW)
    sliced = column_slice_params(cfg, params, 2)
    got = run_case(cfg, sliced, prompts, 8, CPU, **PARITY_KW)
    assert type(sliced["blocks"]["wq"]).sliced > 0    # went through it
    assert all(np.array_equal(a, b) for a, b in zip(want["outs"],
                                                   got["outs"]))
    toks = torch.from_numpy(np.stack([p[:5] for p in prompts[:2]]))
    with torch.inference_mode():
        a, _ = lm.prefill(cfg, params, toks)
        b, _ = lm.prefill(cfg, sliced, toks)
    assert torch.equal(a, b)

"""CondGraph on the card: the WHILE/IF program against ``lower()``.

These tests need an NVIDIA GPU (a CUDA graph has no CPU mode): they carry
the ``gpu`` marker and skip elsewhere. Run them on the card with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_condgraph_gpu.py

They hold ``chip_smoke.py``'s condgraph checks at a small size: every
program of ``repro_torch.bench.condgraph_check`` equals ``lower()`` on the
card and on the CPU (integers exact, fp32 rel <= 1e-5), makes one graph
launch per call and runs under ``set_sync_debug_mode("error")``; the WHILE
program's node count does not grow with the trip count; a block that
cannot be captured is refused with its task's name; a call with another
state shape raises.
"""
import pytest
import torch

from repro_torch.bench import condgraph_check, fig17_conditional_memory
from repro_torch.core import STOP, CondGraph

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def test_programs_equal_lower_on_card_and_cpu(cuda):
    rep = condgraph_check.check_device(cuda, k=16, n=64)
    assert rep["max_abs_err"] <= condgraph_check.FP_REL_TOL
    assert rep["launches"] == 2 * len(rep["programs"])
    assert rep["programs"]["until_small"]["steps"] > 1


def test_while_program_nodes_constant_in_k(cuda):
    p = fig17_conditional_memory.device_panel(cuda, k=32, n=64, reps=2)
    assert p["while_nodes_k8"] == p["while_nodes_k32"]
    assert p["unrolled_nodes_k32"] > 3 * p["unrolled_nodes_k8"]
    assert p["while_iters"] == 32
    assert p["while_count_only_nodes"] < p["while_nodes_k32"]


def test_block_with_a_host_sync_is_refused_with_its_task(cuda):
    g = CondGraph()
    step = g.task(lambda s: {**s, "i": s["i"] + int(s["i"].item() > 3)},
                  name="syncs")
    c = g.cond(lambda s: (torch.where(s["i"] > 5, 1, 0), s), name="c")
    step.precede(c)
    c.precede(step, STOP)
    st = {"i": torch.zeros((), dtype=torch.int32, device=cuda)}
    with pytest.raises(RuntimeError, match="syncs"):
        g.compile(st)


def test_call_with_another_shape_raises(cuda):
    g = condgraph_check.fig17_graph(CondGraph, STOP, torch.where, 4)
    prog = g.compile(condgraph_check.fig17_state(16, cuda, bounded=True))
    with pytest.raises(TypeError, match="differs from the compiled"):
        prog(condgraph_check.fig17_state(8, cuda, bounded=True))

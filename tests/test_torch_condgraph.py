"""CondGraph (the port's in-graph conditional task graphs) against the JAX
package's JaxGraph, on the CPU.

The scenarios of ``tests/test_jaxgraph.py`` are built once
(``repro_torch.bench.condgraph_check.programs``) on both graph classes,
from the same states. The port's ``lower()`` (the plain, host-driven PC
machine) and ``run_reference`` are held against ``JaxGraph.compile`` (jitted)
and its ``run_reference``: exact for integer leaves, rel <= 1e-6 for fp32
(of the leaf's largest magnitude: the matmuls sum in another order).
The error cases must raise the same ``ValueError`` text. One graph pins
where the two differ on purpose: the port starts at the entry task's block,
the JAX package at block 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import STOP as JSTOP
from repro.core import JaxGraph
from repro_torch.bench.condgraph_check import (TorchOps, fig17_graph,
                                               fig17_state, programs,
                                               until_small_graph,
                                               until_small_state)
from repro_torch.core import STOP, CondGraph

FP_REL = 1e-6


class JaxOps:
    G, STOP, where = JaxGraph, JSTOP, staticmethod(jnp.where)

    @staticmethod
    def i32(v):
        return jnp.int32(v)

    @staticmethod
    def f32(v):
        return jnp.float32(v)


SCENARIOS = ["dag", "do_while", "branching", "superblock", "out_of_range",
             "max_iters"]


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _close(got, want):
    got, want = _np(got), _np(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if np.issubdtype(want[k].dtype, np.integer):
            assert got[k].dtype == want[k].dtype and np.array_equal(
                got[k], want[k]), (k, got[k], want[k])
        else:   # relative to the leaf's largest magnitude
            scale = max(float(np.max(np.abs(want[k]))), 1e-30)
            err = float(np.max(np.abs(got[k] - want[k]))) / scale
            assert err <= FP_REL, (k, err)


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_jaxgraph(name):
    jp = programs(JaxOps)[name]
    tp = programs(TorchOps("cpu"))[name]
    want = jax.jit(jp.graph.lower(**jp.kw))(jp.state)
    got = tp.graph.lower(**tp.kw)(tp.state)
    _close(got, want)
    _close(tp.graph.compile(tp.state, **tp.kw)(tp.state), want)
    for leaf, v in tp.expect.items():
        assert float(got[leaf]) == v
    if name != "max_iters":        # loops forever without the bound
        _close(tp.graph.run_reference(tp.state),
               jp.graph.run_reference(jp.state))


def test_superblocks_merge_static_chains():
    jp = programs(JaxOps)["superblock"]
    tp = programs(TorchOps("cpu"))["superblock"]
    jb, _ = jp.graph._blocks()
    tb, _ = tp.graph._blocks()
    assert len(tb) == len(jb) == 1
    assert [n.name for n in tb[0]] == [n.name for n in jb[0]]


def test_entry_block_differs_from_the_reference_on_purpose():
    """Entry added second: the port runs it first (122); the JAX package
    starts at block 0, skips it and gives 222."""
    jp = programs(JaxOps)["entry_block"]
    tp = programs(TorchOps("cpu"))["entry_block"]
    assert [[n.name for n in b] for b in tp.graph._blocks()[0]] == \
        [[n.name for n in b] for b in jp.graph._blocks()[0]] == \
        [["x"], ["entry"], ["c"]]
    assert int(tp.graph.lower()(tp.state)["i"]) == 122
    assert int(tp.graph.run_reference(tp.state)["i"]) == 122
    assert int(jax.jit(jp.graph.lower())(jp.state)["i"]) == 222
    assert int(jp.graph.run_reference(jp.state)["i"]) == 222


def _fanout(ops):
    g = ops.G()
    a = g.task(lambda s: s, name="a")
    b = g.task(lambda s: s, name="b")
    c = g.cond(lambda s: (ops.i32(0), s), name="c")
    a.precede(b)
    a.precede(c)
    c.precede(a, ops.STOP)
    return g


def _two_entries(ops):
    g = ops.G()
    a = g.task(lambda s: s, name="a")
    b = g.task(lambda s: s, name="b")
    c = g.cond(lambda s: (ops.i32(0), s), name="c")
    a.precede(c)
    b.precede(c)
    c.precede(ops.STOP)
    return g


def _unreachable(ops):
    g = ops.G()
    a = g.task(lambda s: s, name="a")
    c = g.cond(lambda s: (ops.i32(1), s), name="c")
    u1 = g.task(lambda s: s, name="u1")
    u2 = g.task(lambda s: s, name="u2")
    a.precede(c)
    c.precede(a, ops.STOP)
    u1.precede(u2)
    u2.precede(u1)
    return g


def _static_cycle(ops):
    g = ops.G()
    a = g.task(lambda s: s, name="a")
    b = g.task(lambda s: s, name="b")
    a.precede(b)
    b.precede(a)
    return g


@pytest.mark.parametrize("build,call", [
    (_fanout, "lower"), (_two_entries, "lower"), (_unreachable, "lower"),
    (_static_cycle, "lower"), (_static_cycle, "_topo_order"),
    (_fanout, "run_reference")])
def test_error_cases_raise_the_same_text(build, call):
    def err(ops, state):
        g = build(ops)
        fn = getattr(g, call)
        with pytest.raises(ValueError) as info:
            fn(state) if call == "run_reference" else fn()
        return str(info.value)

    jmsg = err(JaxOps, {"i": jnp.int32(0)})
    tmsg = err(TorchOps("cpu"), {"i": torch.tensor(0, dtype=torch.int32)})
    assert tmsg == jmsg
    assert any(s in tmsg for s in ("multiple successors", "one entry task",
                                   "unreachable", "no condition task"))


def test_negative_index_takes_no_successor():
    def build(ops):
        g = ops.G()
        c = g.cond(lambda s: (ops.i32(-1), s))
        t = g.task(lambda s: {**s, "i": s["i"] + 100})
        c.precede(t)
        return g

    want = jax.jit(build(JaxOps).lower())({"i": jnp.int32(3)})
    st = {"i": torch.tensor(3, dtype=torch.int32)}
    got = build(TorchOps("cpu")).lower()(st)
    _close(got, want)
    assert int(got["i"]) == 3


def test_fig17_loop_matches_jaxgraph_in_fp32():
    """fig17's body x <- x @ x * 0.5 at a small size (k = 12, 16 x 16, x
    at unit spectral norm)."""
    st = fig17_state(16, bounded=True)
    jg = fig17_graph(JaxGraph, JSTOP, jnp.where, k=12)
    tg = fig17_graph(CondGraph, STOP, torch.where, k=12)
    want = jax.jit(jg.lower())({k: jnp.asarray(v.numpy())
                                for k, v in st.items()})
    got = tg.lower()(st)
    assert int(got["i"]) == 12
    _close(got, want)


def test_data_dependent_loop_matches_jaxgraph():
    st = until_small_state(16)
    jg = JaxGraph()
    step = jg.task(lambda s: {**s, "x": s["m"] @ s["x"], "n": s["n"] + 1})
    small = jg.cond(lambda s: ((jnp.linalg.norm(s["x"]) < 1e-3)
                               .astype(jnp.int32), s))
    step.precede(small)
    small.precede(step, JSTOP)
    want = jax.jit(jg.lower())({k: jnp.asarray(v.numpy())
                                for k, v in st.items()})
    got = until_small_graph(CondGraph, STOP).lower()(st)
    assert int(got["n"]) == int(want["n"]) > 10
    _close(got, want)


def test_block_that_changes_the_state_type_is_refused():
    g = CondGraph()
    t = g.task(lambda s: {**s, "i": s["i"].to(torch.int64)}, name="widen")
    c = g.cond(lambda s: (torch.tensor(1), s), name="c")
    t.precede(c)
    c.precede(t, STOP)
    with pytest.raises(TypeError, match="widen"):
        g.lower()({"i": torch.tensor(0, dtype=torch.int32)})


def test_compile_on_cpu_is_the_plain_version_and_checks_the_state():
    tp = programs(TorchOps("cpu"))["do_while"]
    fn = tp.graph.compile(tp.state)
    assert int(fn(tp.state)["i"]) == 6
    with pytest.raises(TypeError, match="tensors on one device"):
        tp.graph.compile({"i": 0, "x": torch.tensor(1.0)})


def test_empty_graph_is_identity():
    st = {"i": torch.tensor(4, dtype=torch.int32)}
    assert CondGraph().lower()(st) is st

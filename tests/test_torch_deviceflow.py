"""DeviceFlow and the parallel algorithms of the port against the JAX
reference, on the CPU.

The port of ``tests/test_deviceflow_algorithms.py`` (on ``device="cpu"``
the DeviceFlow runs its op list eagerly at every launch), plus: the same
programs on the same numpy inputs through ``repro.core.DeviceFlow`` and
``repro_torch.core.DeviceFlow`` (fp32, 1e-6 absolute: the same fp32 ops),
the stateful re-binding of an input, the refusal without CUDA and an
executor ``DEVICE`` task. Capture and replay on the card are in
``tests/test_torch_deviceflow_gpu.py``.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DeviceFlow as JDeviceFlow
from repro_torch.core import (ACCEL, HOST, DeviceFlow, Executor, TaskError,
                              Taskflow)
from repro_torch.core.algorithms import (linear_pipeline, parallel_for,
                                         parallel_reduce)

CPU = "cpu"


@pytest.fixture(scope="module")
def executor():
    ex = Executor(domains={HOST: 4})
    yield ex
    ex.shutdown(wait=False)


def test_deviceflow_capture_and_offload():
    df = DeviceFlow(CPU)
    x = np.arange(8, dtype=np.float32)
    df.copy("x", x)
    df.kernel(lambda x: x * 2.0, ["x"], ["y"])
    df.kernel(lambda x, y: x + y, ["x", "y"], ["z"])
    df.fetch("z")
    out = df.offload()
    assert isinstance(out["z"], np.ndarray)
    np.testing.assert_allclose(out["z"], x * 3.0)
    # repeated offload reuses the recorded program (one launch each)
    df.offload(2)
    assert df.num_launches == 3
    assert df.captured_launches == {}     # no CUDA graph on the CPU


def test_deviceflow_call_convenience():
    df = DeviceFlow(CPU)
    df.call(lambda a, b: a @ b, np.ones((4, 4), np.float32),
            np.ones((4,), np.float32), out="r")
    out = df.offload()
    np.testing.assert_allclose(out["r"], np.full(4, 4.0))


def test_deviceflow_task_in_executor():
    results = {}
    ex = Executor(domains={HOST: 1, ACCEL: 1}, devices={ACCEL: [CPU]})
    try:
        tf = Taskflow()

        def build(df: DeviceFlow):
            df.copy("a", np.full(16, 3.0, np.float32))
            df.kernel(lambda a: (a * a).sum(), ["a"], ["s"])
            df.fetch("s")
            results["df"] = df

        t = tf.device(build)
        done = tf.static(lambda: results.__setitem__(
            "val", float(results["df"].result("s"))))
        t.precede(done)
        ex.run(tf).wait()
        assert results["val"] == 16 * 9.0
        assert results["df"].device == torch.device(CPU)
        assert results["df"].num_launches == 1
    finally:
        ex.shutdown()


def test_parallel_for(executor):
    tf = Taskflow()
    out = [0] * 100
    entry, exit_ = parallel_for(tf, 100, lambda i: out.__setitem__(i, i * i),
                                chunk=7)
    check = tf.static(lambda: None)
    exit_.precede(check)
    executor.run(tf).wait()
    assert out == [i * i for i in range(100)]


def test_parallel_reduce(executor):
    tf = Taskflow()
    result = [None]
    parallel_reduce(tf, list(range(1, 101)), lambda a, b: a + b, 0,
                    result, chunk=9)
    executor.run(tf).wait()
    assert result[0] == 5050


def test_linear_pipeline(executor):
    tf = Taskflow()
    items = list(range(20))
    it = iter(items)
    lock = threading.Lock()
    sunk = []

    def source():
        with lock:
            return next(it, None)

    linear_pipeline(tf, [lambda x: x + 1, lambda x: x * 2],
                    source, lambda v: sunk.append(v), depth=3)
    executor.run(tf).wait()
    assert sorted(sunk) == sorted((x + 1) * 2 for x in items)


def _program(df, lib, x, w):
    """The same three-op program in either framework."""
    df.copy("x", x)
    df.copy("w", w)
    df.kernel(lambda x, w: lib.tanh(x @ w), ["x", "w"], ["h"])
    df.kernel(lambda h, x: (h * 2.0, x.sum()), ["h", "x"], ["h2", "s"])
    df.fetch("h2", "s")
    return df


def test_results_match_jax_deviceflow():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    w = rng.standard_normal((5, 3)).astype(np.float32)
    j = _program(JDeviceFlow(), jnp, x, w).offload()
    t = _program(DeviceFlow(CPU), torch, x, w).offload()
    assert set(t) == set(j) == {"h2", "s"}
    for k in j:
        np.testing.assert_allclose(t[k], np.asarray(j[k]), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("how", ["copy", "_inputs"])
def test_stateful_rebinding_matches_jax(how):
    """Re-bind the input between launches, as the fig13 taskflow path
    does: the same recorded program runs on the new data."""
    a0 = np.arange(4, dtype=np.float32)
    a1 = np.full(4, 10.0, np.float32)
    outs = {}
    for name, df in (("jax", JDeviceFlow()), ("torch", DeviceFlow(CPU))):
        df.copy("a", a0)
        df.kernel(lambda a: a * a + 1.0, ["a"], ["b"])
        df.fetch("b")
        first = np.asarray(df.offload()["b"]).copy()
        if how == "copy":
            df.copy("a", a1)
        else:
            df._inputs["a"] = a1
        second = np.asarray(df.offload()["b"])
        outs[name] = (first, second, df.num_launches)
    np.testing.assert_allclose(outs["torch"][0], outs["jax"][0])
    np.testing.assert_allclose(outs["torch"][1], outs["jax"][1])
    np.testing.assert_allclose(outs["torch"][1], a1 * a1 + 1.0)
    assert outs["torch"][2] == outs["jax"][2] == 2


def test_rebinding_must_keep_shape_and_dtype():
    df = DeviceFlow(CPU)
    df.copy("a", np.zeros(4, np.float32))
    df.kernel(lambda a: a + 1.0, ["a"], ["b"]).fetch("b")
    df.offload()
    df.copy("a", np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="shape"):
        df.offload()
    df.copy("a", np.zeros(4, np.float64))
    with pytest.raises(TypeError, match="dtype"):
        df.offload()
    df.copy("a", np.ones(4, np.float32))
    np.testing.assert_allclose(df.offload()["b"], np.full(4, 2.0))


def test_results_are_copies():
    df = DeviceFlow(CPU)
    a = np.zeros(3, np.float32)
    df.copy("a", a).fetch("a")
    out = df.offload()["a"]
    out[0] = 7.0
    assert a[0] == 0.0 and df.offload()["a"][0] == 0.0


def test_deviceflow_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFlow()
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceFlow("cuda")


def test_device_task_without_a_device_fails_the_run(monkeypatch):
    """An ACCEL worker bound to no device gives its DeviceFlow CUDA, and
    without CUDA the task fails: no silent move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ex = Executor(domains={HOST: 1, ACCEL: 1})
    try:
        tf = Taskflow()
        tf.device(lambda df: df.copy("a", np.ones(2, np.float32)))
        with pytest.raises(TaskError) as info:
            ex.run(tf).wait()
        assert isinstance(info.value.__cause__, RuntimeError)
        assert not isinstance(info.value.__cause__, NotImplementedError)
    finally:
        ex.shutdown()


def test_nested_condgraph_matches_jax_deviceflow():
    """The third advantage: a DeviceFlow op that is a compiled conditional
    program (the data-dependent loop x <- m @ x until |x| < 1e-3, d = 16)
    between two ops of the flow, against the JAX DeviceFlow nesting
    ``JaxGraph.lower()`` on the same inputs, at three scales of x (three
    trip counts; fp32, rel 1e-5 of each leaf's largest magnitude, the trip
    count exact). On the CPU the compiled program is ``lower()``'s
    function, run eagerly in the flow."""
    from repro.core import STOP as JSTOP
    from repro.core import JaxGraph
    from repro_torch.bench.condgraph_check import (NESTED_SCALES,
                                                   nested_flow,
                                                   until_small_graph,
                                                   until_small_state)
    from repro_torch.core import STOP, CondGraph

    st = until_small_state(16)
    m, x = st["m"].numpy(), st["x"].numpy()
    prog = until_small_graph(CondGraph, STOP).compile(st)
    jprog = until_small_graph(JaxGraph, JSTOP, where=jnp.where,
                              norm=jnp.linalg.norm).lower()
    t = nested_flow(DeviceFlow(CPU), prog, m, x, NESTED_SCALES[0])
    j = nested_flow(JDeviceFlow(), jprog, m, x, NESTED_SCALES[0])
    trips = []
    for launch, s in enumerate(NESTED_SCALES):
        t.copy("scale", np.float32(s))
        j.copy("scale", np.float32(s))
        got, want = t.offload(), j.offload()
        assert t.num_launches == launch + 1
        assert int(got["n_out"]) == int(want["n_out"])
        trips.append(int(got["n_out"]))
        for name in ("x_out", "mx"):
            w = np.asarray(want[name])
            assert np.abs(w).max() > 0
            np.testing.assert_allclose(got[name], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
    assert len(set(trips)) == 3, trips


def test_collection_paused_holds_across_overlapping_captures():
    """Two captures on two threads overlap (A enters, B enters, A leaves,
    B leaves): the collector stays off until the last one leaves and is
    then on again; one inside another on a thread, likewise."""
    import gc

    from repro_torch.device import collection_paused

    assert gc.isenabled()
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def capture_a():
        with collection_paused():
            a_in.set()
            b_in.wait(10)
        seen["after_a"] = gc.isenabled()
        a_out.set()

    def capture_b():
        a_in.wait(10)
        with collection_paused():
            b_in.set()
            a_out.wait(10)
            seen["b_after_a"] = gc.isenabled()
            with collection_paused():
                pass
            seen["b_after_nested"] = gc.isenabled()

    threads = [threading.Thread(target=f) for f in (capture_a, capture_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert seen == {"after_a": False, "b_after_a": False,
                    "b_after_nested": False}
    assert gc.isenabled()


def test_collection_paused_leaves_a_disabled_collector_off():
    import gc

    from repro_torch.device import collection_paused
    gc.disable()
    try:
        with collection_paused():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_close_frees_the_flow_and_the_next_offload_runs_again():
    df = DeviceFlow(CPU)
    df.copy("a", np.arange(4, dtype=np.float32))
    df.kernel(lambda a: a * 2.0, ["a"], ["b"]).fetch("b")
    np.testing.assert_array_equal(df.offload()["b"], [0, 2, 4, 6])
    df.close()
    assert df._captured is None
    np.testing.assert_array_equal(df.offload()["b"], [0, 2, 4, 6])
    assert df.num_launches == 2

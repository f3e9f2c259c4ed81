"""DeviceFlow on the card: CUDA-graph capture against the eager run, replay
counts, captured kernel launches and the stateful re-binding of inputs.

These tests need an NVIDIA GPU (a CUDA graph has no CPU mode): they carry
the ``gpu`` marker and skip elsewhere. Run them on the card with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_deviceflow_gpu.py

Inputs come from numpy with a fixed seed. Tolerance: 1e-5 absolute between
the graph and the same ops run eagerly on the CPU (fp32, summation order
only); the graph against the same ops run eagerly on the card, exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ACCEL, HOST, DeviceFlow, Executor, Taskflow
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda", 0)


def _flow(dev, y, ws, b):
    """Three K4 layers in two captured ops, the fig13 taskflow's shape."""
    df = DeviceFlow(dev)
    df.copy("y", y)
    wt = [torch.from_numpy(w).to(dev) for w in ws]
    bt = torch.from_numpy(b).to(dev)

    def block(ws_):
        def f(x):
            for w in ws_:
                x = ops.lsdnn_layer(x, w, bt, 4.0)
            return x
        return f

    df.kernel(block(wt[:2]), ["y"], ["h"])
    df.kernel(block(wt[2:]), ["h"], ["out"])
    df.kernel(lambda h: h.sum(dim=1), ["h"], ["rowsum"])
    df.fetch("out", "rowsum")
    return df


def _net(seed=0, T=300, F=64):
    rng = np.random.default_rng(seed)
    y = (rng.random((T, F)) < 0.5).astype(np.float32)
    ws = [(rng.standard_normal((F, F)) * 0.2).astype(np.float32)
          for _ in range(3)]
    b = (rng.standard_normal(F) * 0.1).astype(np.float32)
    return y, ws, b


def test_capture_matches_eager_and_counts_replays(cuda):
    y, ws, b = _net()
    cpu = _flow("cpu", y, ws, b).offload()
    df = _flow(cuda, y, ws, b)
    n0 = ops.launch_counts()["lsdnn_layer"]
    out = df.offload()
    # warm-up (3 eager launches) + capture (3 recorded once)
    assert ops.launch_counts()["lsdnn_layer"] - n0 == 6
    assert df.captured_launches == {"lsdnn_layer": 3}
    assert df.num_launches == 1
    for k in ("out", "rowsum"):
        assert isinstance(out[k], np.ndarray)
        np.testing.assert_allclose(out[k], cpu[k], rtol=0, atol=1e-5)
    out2 = df.offload(3)
    assert df.num_launches == 4
    assert ops.launch_counts()["lsdnn_layer"] - n0 == 6   # replays only
    for k in out:
        np.testing.assert_array_equal(out2[k], out[k])


def test_graph_equals_the_same_ops_eager_on_the_card(cuda):
    y, ws, b = _net(seed=1)
    out = _flow(cuda, y, ws, b).offload()
    eager = _flow(cuda, y, ws, b)
    env = {"y": torch.from_numpy(y).to(cuda)}
    ref = eager._run(env)
    for k in out:
        np.testing.assert_array_equal(out[k], ref[k].cpu().numpy())


@pytest.mark.parametrize("how", ["copy", "_inputs"])
def test_rebinding_runs_the_same_graph_on_new_data(cuda, how):
    y, ws, b = _net(seed=2)
    y2 = _net(seed=3)[0]
    df = _flow(cuda, y, ws, b)
    first = df.offload()["out"]
    graph = df._captured.graph
    if how == "copy":
        df.copy("y", y2)
    else:
        df._inputs["y"] = y2
    second = df.offload()["out"]
    assert df._captured.graph is graph          # no re-capture
    want = _flow("cpu", y2, ws, b).offload()["out"]
    np.testing.assert_allclose(second, want, rtol=0, atol=1e-5)
    assert not np.array_equal(first, second)
    df.copy("y", y[:10])
    with pytest.raises(ValueError, match="shape"):
        df.offload()
    df.copy("y", y.astype(np.float64))
    with pytest.raises(TypeError, match="dtype"):
        df.offload()


def test_results_survive_the_next_replay(cuda):
    y, ws, b = _net(seed=4)
    df = _flow(cuda, y, ws, b)
    first = df.offload()["out"]
    keep = first.copy()
    df.copy("y", np.zeros_like(y))
    df.offload()
    np.testing.assert_array_equal(first, keep)


def test_device_task_in_executor_on_the_card(cuda):
    """An ACCEL worker bound to the card captures and replays its flow
    while a HOST worker runs."""
    results = {}
    ex = Executor(domains={HOST: 2, ACCEL: 1}, devices={ACCEL: [cuda]})
    try:
        tf = Taskflow()
        x = np.arange(1024, dtype=np.float32)
        yv = np.ones(1024, np.float32)

        def saxpy(df):
            df.copy("x", x).copy("y", yv)
            df.kernel(lambda x, y: 2.0 * x + y, ["x", "y"], ["z"])
            df.fetch("z")
            results["df"] = df

        t = tf.device(saxpy)
        h = tf.static(lambda: results.__setitem__("host", sum(range(1000))))
        done = tf.static(lambda: results.__setitem__(
            "z", results["df"].result("z")))
        t.precede(done)
        h.precede(done)
        ex.run(tf).wait()
    finally:
        ex.shutdown()
    np.testing.assert_array_equal(results["z"], 2.0 * x + yv)
    assert results["df"].device == cuda
    assert results["df"].num_launches == 1


@pytest.mark.parametrize("d", [16, 256])
def test_flow_nesting_a_compiled_condgraph_equals_lower(cuda, d):
    """A DeviceFlow holding a compiled conditional program: one replay an
    offload runs the loop to its data's end (three scales, three trip
    counts), equal to the same ops around ``lower()`` run eagerly on the
    card (trips exact, fp32 rel 1e-5), and no replay launches the program
    again."""
    from repro_torch.bench.condgraph_check import check_nested
    rep = check_nested(cuda, d=d)
    assert rep["offloads"] == 3 and len(set(rep["trips"])) == 3
    assert rep["program_launches"] == 2     # the warm-up and the capture


def test_flow_nesting_a_compiled_dag_runs_its_composition(cuda):
    """A compiled DAG program called inside the flow's capture runs its
    composition into the flow's graph: one replay an offload gives
    (x + 1) * 3 on every re-bound input."""
    from repro_torch.bench.condgraph_check import TorchOps, programs
    p = programs(TorchOps(cuda))["dag"]
    prog = p.graph.compile(p.state)
    df = DeviceFlow(cuda)
    df.copy("x", np.float32(1.0)).copy("i", np.zeros((), np.int32))
    df.kernel(lambda i, x: prog({"i": i, "x": x})["x"], ["i", "x"], ["y"])
    df.fetch("y")
    for launch, x in enumerate((1.0, 2.5, -4.0)):
        df.copy("x", np.float32(x))
        assert float(df.offload()["y"]) == (x + 1) * 3
        assert df.num_launches == launch + 1


def test_capture_survives_a_dead_graph_in_a_reference_cycle(cuda):
    """A CUDA graph in a dead reference cycle (a closed serve engine's
    captured chunk, say) destroyed by the collector inside another
    capture invalidates that capture; every capture of the port pauses
    the collector (``device.collection_paused``). The collector runs at
    nearly every allocation here."""
    import gc

    class Holder:
        pass

    h = Holder()
    h.cycle = h
    h.graph = torch.cuda.CUDAGraph()
    x = torch.ones(4, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        x * 2                                   # warm-up
    with torch.cuda.graph(h.graph, stream=side):
        x * 2
    del h
    old = gc.get_threshold()
    gc.set_threshold(1)
    try:
        df = DeviceFlow(cuda)
        df.copy("a", np.ones(8, np.float32))
        df.kernel(lambda a: a * 3.0, ["a"], ["b"]).fetch("b")
        np.testing.assert_array_equal(df.offload()["b"], np.full(8, 3.0))
    finally:
        gc.set_threshold(*old)

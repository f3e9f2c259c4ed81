"""Paper Figure 17 (memory panel) / §5.3-5.4: conditional tasking keeps
memory FLAT as the iteration count grows, while DAG frameworks must
statically unroll.

The port of ``benchmarks/fig17_conditional_memory.py``. Two levels:

* host TDG (``fig17/host/*``, the reference's rows): task count + graph
  bytes of the cyclic conditional taskflow vs an unrolled DAG, across
  iteration counts, on ``repro_torch.core``;
* device (``fig17/cuda/*``, on the card only): where the reference compares
  the HLO text of a ``JaxGraph`` while-loop program with the same loop
  unrolled, this compares three forms of the loop ``x <- x @ x * 0.5``
  (k = 256, x 256 x 256 fp32 of ones, which overflows to inf as the
  reference's does; fp32 products on the CUDA cores, TF32 off):

  - ``while``: :class:`repro_torch.core.CondGraph` compiled into ONE CUDA
    graph with a WHILE node (the step and the test as one block);
  - ``unrolled``: the k steps captured into one CUDA graph;
  - ``host_loop``: ``CondGraph.lower()`` on the card, the PC machine driven
    from the host (one index read-back per iteration);

  and, to split the WHILE program's time, the same program with the
  matmul taken out of its step (``while_count_only``: the counter, the
  test, the copy-back and the control nodes alone).

  Rows: graph nodes at k = 8 and k = 256 (counted through the WHILE body,
  the IF bodies and child graphs), their ratio at k = 256, capture and
  instantiate ms, the ms of a call (copy in, one launch, copy out) and the
  bytes of each graph form's memory pool (the caching allocator's segments
  of that pool; the static state and the cuBLAS workspace lie outside it),
  and the host loop's ms.
"""
from __future__ import annotations

import sys
import time

import torch

from ..device import collection_paused, resolve_device
from ..core import STOP, CondGraph, Taskflow
from .condgraph_check import fig17_graph, fig17_state


def _host_graph_bytes(tf: Taskflow) -> int:
    total = 0
    for n in tf._nodes:
        total += sys.getsizeof(n)
        total += sys.getsizeof(n.successors)
    return total


def host_rows(iters=(8, 64, 512)):
    rows = []
    for k in iters:
        # cyclic conditional: constant 3 tasks for ANY k
        tf = Taskflow()
        state = {"i": 0}
        body = tf.static(lambda: None)

        def cond(k=k, state=state) -> int:
            state["i"] += 1
            return 1 if state["i"] >= k else 0

        c = tf.condition(cond)
        stop = tf.static(lambda: None)
        body.precede(c)
        c.precede(body, stop)
        rows.append((f"fig17/host/cyclic_k{k}_tasks", tf.num_tasks(),
                     "constant"))
        rows.append((f"fig17/host/cyclic_k{k}_bytes", _host_graph_bytes(tf),
                     "constant"))

        # unrolled: k tasks
        tfu = Taskflow()
        prev = None
        for _ in range(k):
            t = tfu.static(lambda: None)
            if prev is not None:
                prev.precede(t)
            prev = t
        rows.append((f"fig17/host/unrolled_k{k}_tasks", tfu.num_tasks(),
                     "grows with k"))
        rows.append((f"fig17/host/unrolled_k{k}_bytes",
                     _host_graph_bytes(tfu), "grows with k"))
    return rows


def pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in the segments of a CUDA-graph
    memory pool (``CUDAGraph.pool()`` / ``graph_pool_handle()``)."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))


def _unrolled(x: torch.Tensor, k: int, dev):
    """The k steps captured into one CUDA graph (``keep_graph`` so its nodes
    can be counted), instantiated; returns (a call: copy in, replay, fresh
    output; the graph's nodes; its memory pool)."""
    from ..kernels import cond_graph
    static = x.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):         # warm-up, outside capture
        _ = static @ static * 0.5
    side.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with collection_paused(), torch.cuda.graph(
            g, stream=side, capture_error_mode="thread_local"):
        xx = static
        for _ in range(k):
            xx = xx @ xx * 0.5
    nodes = cond_graph.count_nodes(g.raw_cuda_graph(), dev.index)
    g.instantiate()

    def call(x_in: torch.Tensor) -> torch.Tensor:
        static.copy_(x_in, non_blocking=True)
        g.replay()
        return xx.clone()

    return call, nodes, g.pool()


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def device_panel(dev, k: int = 256, n: int = 256, reps: int = 20) -> dict:
    """The three forms of fig17's loop on the card; returns its numbers
    (see the module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    st = fig17_state(n, dev)
    out: dict = {"k": k, "n": n}
    for kk in sorted({8, k}):
        g = fig17_graph(CondGraph, STOP, torch.where, kk)
        out[f"while_nodes_k{kk}"] = g.compile(st).nodes()
        out[f"unrolled_nodes_k{kk}"] = _unrolled(st["x"], kk, dev)[1]
    g = fig17_graph(CondGraph, STOP, torch.where, k)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    prog = g.compile(st)
    torch.cuda.synchronize(dev)
    out["while_capture_ms"] = (time.perf_counter() - t0) * 1e3
    out["while_pool_bytes"] = pool_bytes(prog.pool)
    t0 = time.perf_counter()
    unrolled, _, pool = _unrolled(st["x"], k, dev)
    torch.cuda.synchronize(dev)
    out["unrolled_capture_ms"] = (time.perf_counter() - t0) * 1e3
    out["unrolled_pool_bytes"] = pool_bytes(pool)
    # a call each: the input copied into the static state, one launch, the
    # result copied out; in turns: while, unrolled, unrolled, while
    w1 = _events_ms(lambda: prog(st), reps)
    u1 = _events_ms(lambda: unrolled(st["x"]), reps)
    u2 = _events_ms(lambda: unrolled(st["x"]), reps)
    w2 = _events_ms(lambda: prog(st), reps)
    out["while_replay_ms"] = (w1 + w2) / 2
    out["unrolled_replay_ms"] = (u1 + u2) / 2
    plain = g.lower()
    plain(st)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        plain(st)
    torch.cuda.synchronize(dev)
    out["host_loop_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    out["while_iters"] = int(prog(st)["i"])
    count = CondGraph()
    step = count.task(lambda s: {**s, "i": s["i"] + 1})
    done = count.cond(lambda s: (torch.where(s["i"] >= k, 1, 0), s))
    step.precede(done)
    done.precede(step, STOP)
    cprog = count.compile(st)
    out["while_count_only_nodes"] = cprog.nodes()
    out["while_count_only_ms"] = _events_ms(lambda: cprog(st), reps)
    return out


def device_rows(p: dict) -> list:
    k = p["k"]
    rows = []
    for kk in sorted({8, k}):
        rows += [(f"fig17/cuda/while_nodes_k{kk}", p[f"while_nodes_k{kk}"],
                  "conditional in-graph (constant in k)"),
                 (f"fig17/cuda/unrolled_nodes_k{kk}",
                  p[f"unrolled_nodes_k{kk}"], "static unroll (grows with k)")]
    rows += [
        ("fig17/cuda/node_ratio", p[f"unrolled_nodes_k{k}"]
         / p[f"while_nodes_k{k}"], "unrolled / conditional"),
        ("fig17/cuda/while_capture_ms", p["while_capture_ms"],
         "capture + instantiate (blocks, WHILE/IF program)"),
        ("fig17/cuda/unrolled_capture_ms", p["unrolled_capture_ms"],
         "capture + instantiate"),
        ("fig17/cuda/while_replay_ms", p["while_replay_ms"],
         f"a call: copy in, one launch of {p['while_iters']} iterations, "
         "copy out"),
        ("fig17/cuda/unrolled_replay_ms", p["unrolled_replay_ms"],
         "a call: copy in, one launch, copy out"),
        ("fig17/cuda/host_loop_ms", p["host_loop_ms"],
         "lower() on the card: one index read-back per iteration"),
        ("fig17/cuda/while_count_only_ms", p["while_count_only_ms"],
         f"the WHILE program without the matmul "
         f"({p['while_count_only_nodes']} nodes)"),
        ("fig17/cuda/while_pool_bytes", p["while_pool_bytes"],
         "segments of the blocks' shared graph pool"),
        ("fig17/cuda/unrolled_pool_bytes", p["unrolled_pool_bytes"],
         "segments of the graph's pool"),
    ]
    return rows


def bench(iters=(8, 64, 512), device=None):
    """The host rows, and on a CUDA device the device panel's."""
    rows = host_rows(iters)
    dev = resolve_device(device)
    if dev.type == "cuda":
        rows += device_rows(device_panel(dev))
    return rows


if __name__ == "__main__":
    for name, val, derived in bench():
        print(f"{name},{val},{derived}")

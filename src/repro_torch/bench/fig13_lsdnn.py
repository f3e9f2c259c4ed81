"""Paper Figure 13 / §5.3 on the card: sparse-DNN inference (LSDNN).

The port of ``benchmarks/fig13_lsdnn.py``. The workload: Y <- clamp(relu(Y
@ W_l + b), 0, 32) over many layers, with a host-side scoring/condition
step driving a data-dependent loop — the paper's decomposition (cudaFlows
of layer kernels + condition tasks for the dispatch loop). Every layer runs
through ``ops.lsdnn_layer``, so on the card every layer is a launch of K4
(``kernels/csrc/lsdnn_layer.cu``); on the CPU it is the plain version.

Three paths, with the reference's row names (``fig13/*``):

* sequential — a plain loop, one launch per layer, the layer's weights
  uploaded from the host at every call (no reuse, as the reference's
  per-call ``jnp.asarray(w)``);
* unrolled   — one prepared callable per layer over device-resident
  weights, every pass unrolled into a flat list: one host launch per layer
  per pass (the paper's oneTBB/StarPU-style unrolled TDG);
* taskflow   — the condition-task cycle on the port's ``Executor`` (one
  ACCEL worker): each pass re-binds the flow's input (stateful capture) and
  offloads one ``DeviceFlow`` whose CUDA graph holds every layer
  (``block`` layers per captured op): ONE graph replay per pass.

Every path chains its passes (pass p + 1 starts from pass p's output), as
the reference's taskflow path does. The reference's sequential and
unrolled oracles restart each pass from Y0, so its ``result_max_err``
compares p chained passes with one pass; here all three paths run the same
chained computation and ``result_max_err`` is the largest difference from
the sequential path.

Configurations (``--config``):

* ``fig13`` — the reference's ``_make_net`` byte for byte: dense normal x
  0.05 weights with 70% zeroed, a normal x 0.1 bias, 256 binary input rows
  at density 0.2. The parity configuration.
* ``hpec`` — the MIT/IEEE/Amazon HPEC Graph Challenge "Sparse Deep Neural
  Network" (Kepner et al., HPEC 2019), its network of 1024 neurons and 120
  layers: 32 nonzero weights of 1/16 per neuron at seeded random rows (a
  stand-in for the RadiX-Net connections), bias -0.3, cap (YMAX) 32, and
  60,000 binary input rows at density 0.3 (a stand-in for the
  MNIST-derived inputs). The kernel works on the dense form, as the TPU
  kernel does: W is 120 x 4 MiB of fp32.

    PYTHONPATH=src python -m repro_torch.bench.fig13_lsdnn [--config hpec]
        [--passes 2] [--block 8] [--seed 0] [--device cuda]

Prints ``name,value,derived`` rows and, last, a JSON line with the device
and the rows. Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import ACCEL, HOST, DeviceFlow, Executor, Taskflow
from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import lsdnn_layer_ref

__all__ = ["Net", "PathResult", "make_fig13", "make_hpec", "run_paths",
           "plain_output", "categories", "rows_of", "bench", "main"]

CAP = 32.0
# the HPEC sparse-DNN challenge's 1024-neuron network
HPEC = dict(layers=120, neurons=1024, rows=60000)
HPEC_NNZ = 32               # nonzero weights per neuron
HPEC_WEIGHT = 1.0 / 16
HPEC_BIAS = -0.3
HPEC_DENSITY = 0.3          # of the binary input rows


@dataclasses.dataclass
class Net:
    """Weights per layer (F, G), one bias (G,) shared by every layer and
    the input rows (T, F), all fp32 numpy on the host."""
    ws: List[np.ndarray]
    b: np.ndarray
    y0: np.ndarray
    cap: float = CAP


@dataclasses.dataclass
class PathResult:
    y: np.ndarray               # final output (T, G)
    ms: float                   # wall time of the passes, device synced
    calls: int                  # host launches (per layer, or per pass)
    tasks: Optional[int]        # task-graph size (None: no task graph)
    kernel_launches: int        # K4 launches on the device, warm-up included
    peak_device_mb: float       # peak device memory the path added
    peak_rss_mb: float          # process peak RSS after the path
    graph: Dict[str, int] = dataclasses.field(default_factory=dict)


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def make_fig13(layers: int = 48, neurons: int = 512, seed: int = 0) -> Net:
    """The reference's ``_make_net``, draw for draw."""
    rng = np.random.default_rng(seed)
    ws = []
    for _ in range(layers):
        w = rng.standard_normal((neurons, neurons)).astype(np.float32) * 0.05
        w[rng.random(w.shape) < 0.7] = 0.0   # sparse weights
        ws.append(w)
    b = rng.standard_normal(neurons).astype(np.float32) * 0.1
    y0 = (rng.random((256, neurons)) < 0.2).astype(np.float32)
    return Net(ws, b, y0)


def make_hpec(layers: int = HPEC["layers"], neurons: int = HPEC["neurons"],
              rows: int = HPEC["rows"], seed: int = 0) -> Net:
    """The HPEC challenge's shape and parameters on seeded data: each
    neuron (column of W) reads ``HPEC_NNZ`` distinct random inputs with
    weight 1/16."""
    if neurons <= HPEC_NNZ:
        raise ValueError(f"hpec needs more than {HPEC_NNZ} neurons")
    rng = np.random.default_rng(seed)
    cols = np.arange(neurons)[:, None]
    ws = []
    for _ in range(layers):
        src = rng.random((neurons, neurons), dtype=np.float32).argpartition(
            HPEC_NNZ, axis=1)[:, :HPEC_NNZ]       # (G, nnz) input rows
        w = np.zeros((neurons, neurons), np.float32)
        w[src, cols] = HPEC_WEIGHT
        ws.append(w)
    b = np.full(neurons, HPEC_BIAS, np.float32)
    y0 = (rng.random((rows, neurons), dtype=np.float32)
          < HPEC_DENSITY).astype(np.float32)
    return Net(ws, b, y0)


def _k4() -> int:
    return ops.launch_counts()["lsdnn_layer"]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _begin(dev: torch.device) -> int:
    """Reset the device's peak-memory counter; returns the bytes resident
    now, which a path's peak is measured above."""
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _peak_mb(dev: torch.device, base: int) -> float:
    if dev.type == "cuda":
        return (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    return 0.0


def _device_net(net: Net, dev: torch.device):
    return ([torch.from_numpy(w).to(dev) for w in net.ws],
            torch.from_numpy(net.b).to(dev))


def _block_fn(ws_block, b, cap):
    def f(y):
        for w in ws_block:
            y = ops.lsdnn_layer(y, w, b, cap)
        return y
    return f


def run_sequential(net: Net, passes: int, dev: torch.device) -> PathResult:
    base = _begin(dev)
    b = torch.from_numpy(net.b).to(dev)
    k0 = _k4()
    t0 = time.perf_counter()
    calls = 0
    y = torch.from_numpy(net.y0).to(dev)
    for _ in range(passes):
        for w in net.ws:
            y = ops.lsdnn_layer(y, torch.from_numpy(w).to(dev), b, net.cap)
            calls += 1
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return PathResult(y.cpu().numpy(), ms, calls, None, _k4() - k0,
                      _peak_mb(dev, base), peak_rss_mb())


def run_unrolled(net: Net, passes: int, dev: torch.device) -> PathResult:
    base = _begin(dev)
    wd, b = _device_net(net, dev)
    fns = [_block_fn([w], b, net.cap) for w in wd]
    k0 = _k4()
    t0 = time.perf_counter()
    calls = 0
    y = torch.from_numpy(net.y0).to(dev)
    for _ in range(passes):
        for f in fns:
            y = f(y)
            calls += 1
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return PathResult(y.cpu().numpy(), ms, calls, passes * len(fns),
                      _k4() - k0, _peak_mb(dev, base), peak_rss_mb())


def run_taskflow(net: Net, passes: int, block: int,
                 dev: torch.device) -> PathResult:
    base = _begin(dev)
    wd, b = _device_net(net, dev)
    blocks = [wd[i:i + block] for i in range(0, len(wd), block)]
    df = DeviceFlow(dev)
    df.copy("y", net.y0)
    prev = "y"
    for bi, bl in enumerate(blocks):
        df.kernel(_block_fn(bl, b, net.cap), [prev], [f"y{bi}"],
                  name=f"block{bi}")
        prev = f"y{bi}"
    df.fetch(prev)

    ex = Executor(domains={HOST: 2, ACCEL: 1}, devices={ACCEL: [dev]})
    state = {"pass": 0, "y": net.y0, "launches": 0}
    tf = Taskflow("lsdnn")
    init = tf.static(lambda: state.update(y=net.y0), name="init")

    def infer():
        df.copy("y", state["y"])   # stateful capture: new input, same graph,
        out = df.offload()         # ONE launch: one CUDA graph replay
        state["y"] = out[prev]
        state["launches"] += 1

    t_infer = tf.static(infer, name="infer", domain=ACCEL)

    def score() -> int:
        state["pass"] += 1
        return 1 if state["pass"] >= passes else 0

    cond = tf.condition(score, name="score")
    done = tf.static(lambda: None, name="done")
    init.precede(t_infer)
    t_infer.precede(cond)
    cond.precede(t_infer, done)

    k0 = _k4()
    try:
        df.offload()   # warm-up: eager run, CUDA graph capture, one replay
        t0 = time.perf_counter()
        ex.run(tf).wait()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        ex.shutdown()
    calls_at_wrapper = _k4() - k0
    captured = df.captured_launches.get("lsdnn_layer", 0)
    # the wrapper counted each captured launch once, at capture; on the
    # device it ran once per replay
    k4 = calls_at_wrapper - captured + captured * df.num_launches
    graph = {"captured_k4": captured, "replays": df.num_launches,
             "wrapper_k4": calls_at_wrapper}
    return PathResult(state["y"], ms, state["launches"], tf.num_tasks(), k4,
                      _peak_mb(dev, base), peak_rss_mb(), graph)


def run_paths(net: Net, passes: int, block: int,
              dev: torch.device) -> Dict[str, PathResult]:
    """The three paths, in the reference's order."""
    out = {"sequential": run_sequential(net, passes, dev)}
    out["unrolled"] = run_unrolled(net, passes, dev)
    out["taskflow"] = run_taskflow(net, passes, block, dev)
    return out


def plain_output(net: Net, passes: int, dev: torch.device) -> np.ndarray:
    """The same chained passes through the plain version on ``dev``."""
    wd, b = _device_net(net, dev)
    y = torch.from_numpy(net.y0).to(dev)
    for _ in range(passes):
        for w in wd:
            y = lsdnn_layer_ref(y, w, b, net.cap)
    return y.cpu().numpy()


def categories(y: np.ndarray) -> np.ndarray:
    """The challenge's categories: the rows with any nonzero output."""
    return np.flatnonzero((y != 0).any(axis=1))


def rows_of(res: Dict[str, PathResult]) -> list:
    s, u, t = res["sequential"], res["unrolled"], res["taskflow"]
    err = max(float(np.max(np.abs(u.y - s.y))),
              float(np.max(np.abs(t.y - s.y))))
    rows = [
        ("fig13/sequential_ms", s.ms, "per-layer launches, weights "
         "uploaded per call"),
        ("fig13/sequential_launches", s.calls, "host->device calls"),
        ("fig13/unrolled_ms", u.ms, "unrolled TDG"),
        ("fig13/unrolled_launches", u.calls, "host->device calls"),
        ("fig13/unrolled_tasks", u.tasks, "graph size grows"),
        ("fig13/taskflow_ms", t.ms, "cyclic TDG + DeviceFlow (CUDA graph)"),
        ("fig13/taskflow_launches", t.calls,
         "ONE launch per pass (CUDA-graph effect)"),
        ("fig13/taskflow_tasks", t.tasks, "graph size CONSTANT"),
        ("fig13/result_max_err", err, "vs sequential, same chained passes"),
        ("fig13/peak_rss_mb", peak_rss_mb(), "memory panel"),
    ]
    for name, r in res.items():
        rows += [(f"fig13/{name}_kernel_launches", r.kernel_launches,
                  "K4 launches on the device"),
                 (f"fig13/{name}_peak_device_mb", r.peak_device_mb,
                  "peak device memory above the path's start")]
    rows.append(("fig13/categories", len(categories(s.y)),
                 f"rows with any nonzero output, of {len(s.y)}"))
    return rows


def bench(config: str = "fig13", layers: Optional[int] = None,
          neurons: Optional[int] = None, block: int = 8, passes: int = 3,
          seed: int = 0, device=None) -> list:
    """Rows of the three paths on the named configuration; ``layers`` and
    ``neurons`` default to the configuration's own."""
    dev = resolve_device(device)
    if config == "fig13":
        net = make_fig13(layers or 48, neurons or 512, seed)
    elif config == "hpec":
        net = make_hpec(layers or HPEC["layers"], neurons or HPEC["neurons"],
                        seed=seed)
    else:
        raise ValueError(f"unknown config {config!r} (fig13 or hpec)")
    return rows_of(run_paths(net, passes, block, dev))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("hpec", "fig13"), default="hpec")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--neurons", type=int, default=None)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it); 'cpu' runs "
                         "the plain version")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("fig13_lsdnn needs a CUDA device (or --device cpu)")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"
    print(f"[device] {card}", flush=True)
    rows = bench(args.config, args.layers, args.neurons, args.block,
                 args.passes, args.seed, dev)
    for name, val, derived in rows:
        print(f"{name},{val},{derived}", flush=True)
    print(json.dumps({"device": card, "config": args.config,
                      "passes": args.passes, "block": args.block,
                      "seed": args.seed,
                      "rows": {n: v for n, v, _ in rows}}))


if __name__ == "__main__":
    main()

"""VLSI-placement-style optimization loop (paper §5.4 analogue) on the port.

The port of ``examples/placement_loop.py``: an iterative refinement with a
data-dependent convergence condition, expressed as ONE cyclic task graph:
a device phase (one gradient step on the cell coordinates, on the ACCEL
worker), a host phase (wirelength scoring) and a condition task that
decides convergence. No unrolling; the same five tasks run any number of
iterations.

    PYTHONPATH=src python -m repro_torch.examples.placement_loop [--device cpu]

The reference differentiates the quadratic wirelength proxy
``sum((p[a] - p[b])**2)`` with ``jax.grad``; here its gradient is written
out: ``2 (a - b)`` added at every net's first cell and subtracted at its
second (``index_add_``, the scatter-add ``jax.grad`` builds). The data are
drawn as the reference draws them (``np.random.default_rng(0)``: the
cells' positions, then the nets). Without ``--device`` the loop runs on
CUDA and raises without it; ``--device cpu`` runs it on the CPU.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import ACCEL, HOST, Executor, Taskflow
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    """Run the loop; returns ``{"history": wirelengths, "iterations": n,
    "tasks": graph size}`` (the reference only prints them)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=4096)
    ap.add_argument("--nets", type=int, default=8192)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--max-iters", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="the refine step's device (default: CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    pos = torch.from_numpy(
        rng.random((args.cells, 2)).astype(np.float32)).to(dev)
    nets = torch.from_numpy(rng.integers(
        0, args.cells, size=(args.nets, 2)).astype(np.int32)).to(dev).long()
    a_idx, b_idx = nets[:, 0], nets[:, 1]

    def wirelength(p: torch.Tensor) -> float:
        return float((p[a_idx] - p[b_idx]).abs().sum())

    def refine(p: torch.Tensor) -> torch.Tensor:
        # one smoothed-gradient step on the quadratic wirelength proxy
        d2 = 2.0 * (p[a_idx] - p[b_idx])
        g = torch.zeros_like(p).index_add_(0, a_idx, d2) \
            .index_add_(0, b_idx, -d2)
        return (p - 0.002 * g).clamp(0.0, 1.0)

    wl0 = wirelength(pos)
    state = {"pos": pos, "wl": wl0, "it": 0, "history": [wl0]}

    ex = Executor(domains={HOST: 2, ACCEL: 1}, devices={ACCEL: [dev]})
    tf = Taskflow("placement")

    init = tf.static(lambda: print(f"initial wirelength "
                                   f"{state['wl']:.1f}"))

    def device_refine():
        state["pos"] = refine(state["pos"])

    t_refine = tf.static(device_refine, name="refine", domain=ACCEL)

    def score() -> int:
        wl = wirelength(state["pos"])
        rel = (state["wl"] - wl) / max(state["wl"], 1e-9)
        state["wl"] = wl
        state["it"] += 1
        state["history"].append(wl)
        converged = rel < args.tol or state["it"] >= args.max_iters
        return 1 if converged else 0

    t_cond = tf.condition(score, name="converged?")
    t_done = tf.static(lambda: None, name="done")

    init.precede(t_refine)
    t_refine.precede(t_cond)
    t_cond.precede(t_refine, t_done)    # 0 -> iterate, 1 -> stop

    try:
        ex.run(tf).wait()
    finally:
        ex.shutdown()
    h = state["history"]
    print(f"converged after {state['it']} iterations "
          f"(graph has {tf.num_tasks()} tasks, constant for any count)")
    print(f"wirelength {h[0]:.1f} -> {h[-1]:.1f} "
          f"({100 * (1 - h[-1]/h[0]):.1f}% reduction) on {dev}")
    return {"history": h, "iterations": state["it"],
            "tasks": tf.num_tasks()}


if __name__ == "__main__":
    main()

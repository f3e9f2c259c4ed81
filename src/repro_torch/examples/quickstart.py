"""Quickstart: the five task types of the paper on one page, on the port.

The port of ``examples/quickstart.py``: the same five listings on
``repro_torch.core``. Listing 5's DeviceFlow (the paper's cudaFlow) runs
on the card: one CUDA graph, launched by one replay.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Without ``--device`` the device listing needs a CUDA device and raises
without one; ``--device cpu`` runs it eagerly on the CPU.
"""
import argparse

import numpy as np

from repro_torch.core import ACCEL, HOST, DeviceFlow, Executor, Taskflow
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="listing 5's device (default: CUDA)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    executor = Executor(domains={HOST: 4, ACCEL: 1}, devices={ACCEL: [dev]})

    # -- Listing 1: static tasking --------------------------------------------
    taskflow = Taskflow("quickstart")
    A, B, C, D = taskflow.emplace(
        lambda: print("Task A"),
        lambda: print("Task B"),
        lambda: print("Task C"),
        lambda: print("Task D"),
    )
    A.precede(B, C)     # A runs before B and C
    D.succeed(B, C)     # D runs after  B and C
    executor.run(taskflow).wait()

    # -- Listing 2: dynamic tasking (subflow) ---------------------------------
    tf2 = Taskflow()
    A2 = tf2.static(lambda: print("A"))

    def make_subflow(sf):
        print("B spawns B1,B2,B3")
        b1 = sf.static(lambda: print("  B1"))
        b2 = sf.static(lambda: print("  B2"))
        b3 = sf.static(lambda: print("  B3 (joins B1,B2)"))
        b3.succeed(b1, b2)

    B2 = tf2.dynamic(make_subflow)
    C2 = tf2.static(lambda: print("C"))
    D2 = tf2.static(lambda: print("D (after subflow joined)"))
    A2.precede(B2, C2)
    D2.succeed(B2, C2)
    executor.run(tf2).wait()

    # -- Listing 3: composable tasking ----------------------------------------
    inner = Taskflow("inner")
    ia = inner.static(lambda: print("inner A"))
    ib = inner.static(lambda: print("inner B"))
    ia.precede(ib)
    outer = Taskflow("outer")
    c = outer.static(lambda: print("outer C"))
    mod = outer.composed_of(inner)
    d = outer.static(lambda: print("outer D"))
    c.precede(mod)
    mod.precede(d)
    executor.run(outer).wait()

    # -- Listing 4: conditional tasking (cycles!) -----------------------------
    tf4 = Taskflow()
    state = {"n": 0}
    init = tf4.static(lambda: print("init"))

    def coin() -> int:
        state["n"] += 1
        print(f"  flip #{state['n']}")
        return 1 if state["n"] >= 3 else 0   # 0 -> loop back, 1 -> continue

    cond = tf4.condition(coin)
    stop = tf4.static(lambda: print("stop"))
    init.precede(cond)
    cond.precede(cond, stop)   # successor 0 is itself: a cycle, not a DAG
    executor.run(tf4).wait()

    # -- Listing 5: device tasking (DeviceFlow = cudaFlow) --------------------
    tf5 = Taskflow()
    flows = []

    def saxpy(df: DeviceFlow):
        n = 1 << 16
        df.copy("x", np.ones(n, np.float32))
        df.copy("y", np.full(n, 2.0, np.float32))
        df.kernel(lambda x, y: 2.0 * x + y, ["x", "y"], ["z"])  # one graph
        df.fetch("z")
        flows.append(df)       # keep a handle for the check below

    dev_task = tf5.device(saxpy)
    ok = {}

    def check():
        ok["saxpy"] = bool((flows[0].result("z") == 4.0).all())
        print(f"saxpy ok on {flows[0].device}:", ok["saxpy"])

    dev_task.precede(tf5.static(check))
    executor.run(tf5).wait()

    executor.shutdown()
    if not ok.get("saxpy"):
        raise SystemExit("quickstart: saxpy gave a wrong result")
    print("quickstart complete")


if __name__ == "__main__":
    main()

"""The paper's flagship workload (§5.3) on the port: Large Sparse DNN
inference as a conditional task graph.

The port of ``examples/lsdnn_inference.py``: condition tasks drive the
data-dependent pass loop, and each pass offloads ONE captured device graph
(all layer blocks) in a single launch; every layer is K4, the hand-written
``clamp(relu(Y W + b), cap)`` kernel, on CUDA. The rows are
:func:`repro_torch.bench.fig13_lsdnn.bench`'s, which carry the names of
the reference rows (``benchmarks/fig13_lsdnn.py``).

    PYTHONPATH=src python -m repro_torch.examples.lsdnn_inference --layers 48
    PYTHONPATH=src python -m repro_torch.examples.lsdnn_inference \
        --device cpu --layers 8 --neurons 64

Without ``--device`` it runs on CUDA and raises without it.
"""
import argparse

from repro_torch.bench.fig13_lsdnn import bench
from repro_torch.device import resolve_device


def main(argv=None) -> list:
    """Print and return the ``(name, value, derived)`` rows."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--neurons", type=int, default=512)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it)")
    args = ap.parse_args(argv)
    rows = bench(layers=args.layers, neurons=args.neurons,
                 passes=args.passes, device=resolve_device(args.device))
    for name, val, derived in rows:
        print(f"{name:36s} {val:14.3f}  {derived}")
    return rows


if __name__ == "__main__":
    main()

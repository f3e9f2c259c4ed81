"""The readings that set the limits of ``correct``, on the chip at a
cell's own size, several seeds in one process.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--seconds 20] [--controls 3]

Serve cells: one engine is built; for each seed the weights are drawn
again in place, a window of the cell's traffic at its own rate is served,
and the sampled answers are read against the float32 reference: the
program's widest logit gap (a lower reading) and, for the first
``--controls`` seeds, the control's: at the same positions of the same
prompts and served tokens, the gap of the token the reference computed
in float8 (e4m3 products, the precision below the configuration's
bfloat16) puts first (an upper reading).

Train cells: for each seed the reference follows the cell's first steps
in float32, in float8 (the control) and in float32 on half of each batch,
the mean taken over the rest (a fault planted in the reference put in the
program's place); each is held against the float32 reference as the
program is. A step that leaves the state unchanged reads 1 by the change
measure and needs no run.

No benchmark run calls this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import correct, harness, weights  # noqa: E402


def redraw(flat, ref, conf, seed: int) -> None:
    """The seed's weights, written into the served tensors leaf by leaf
    (the engine's captured chunk keeps their addresses)."""
    import torch
    for name, (shape, init, matrix) in ref.shapes(conf).items():
        t = flat[name]
        t.copy_(weights.draw(shape, init, t.dtype, seed, name, t.device))
    weights.zero_padding(flat, conf["vocab_size"])
    if t.is_cuda:
        torch.cuda.synchronize()


def serve_readings(spec, seeds, seconds, controls, dev):
    from perfbench.runners import serve
    base = harness.Run(spec=spec, seed=seeds[0], seconds=seconds,
                       trace=False, device=dev, t_start=T_START)
    ctx = serve.setup(base)
    try:
        for i, seed in enumerate(seeds):
            redraw(ctx["flat"], ctx["ref"], spec.conf, seed)
            r = harness.Run(spec=spec, seed=seed, seconds=seconds,
                            trace=False, device=dev, t_start=T_START)
            serve.measure(r, ctx)
            got = correct.serve(r, ctx["ref"], ctx["flat"],
                                control=i < controls)
            print(json.dumps({"seed": seed, "unserved": r.failed, **got}),
                  flush=True)
    finally:
        serve.teardown(base, ctx)


def train_readings(spec, seeds, dev):
    ref = spec.reference()
    steps = int(spec.cell.get("ref_steps", spec.mix["warm_steps"]))
    half = {**spec.mix, "batch": spec.mix["batch"] // 2,
            "microbatches": max(1, spec.mix["microbatches"] // 2)}
    for seed in seeds:
        r = harness.Run(spec=spec, seed=seed, seconds=0, trace=False,
                        device=dev, t_start=T_START)
        base = correct.reference_train(r, ref, steps)
        out = {"seed": seed}
        for name, s, prec in (
                ("control", spec, "fp8"),
                ("half_batch", dataclasses.replace(spec, mix=half), "fp32")):
            rr = harness.Run(spec=s, seed=seed, seconds=0, trace=False,
                             device=dev, t_start=T_START)
            got = correct.reference_train(rr, ref, steps, prec)
            correct.train(rr, got, base)
            out[name] = {k: v for k, (v, _) in rr.compared.items()}
        print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--controls", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    spec = harness.load_spec(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(json.dumps({"card": harness.card_info()}), flush=True)
    run_readings(spec, seeds, args.seconds, args.controls, dev)
    return 0


def run_readings(spec, seeds, seconds, controls, dev):
    if spec.generator().RUNNER == "serve":
        serve_readings(spec, seeds, seconds, controls, dev)
    else:
        train_readings(spec, seeds, dev)


if __name__ == "__main__":
    sys.exit(main())

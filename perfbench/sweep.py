"""Find a serve cell's knee: offer its traffic at a list of rates, on one
engine built once, and report for each rate the requests offered and
finished in the window, whether the backlog grew over it, and the cell's
end-to-end metrics.

    python3 perfbench/sweep.py --workload <serve cell> --rates 0.5,1,1.5 \\
        --seconds 20 --seed <n>

Each rate's window follows its own ramp on an idle engine. A rate is
sustained when the output tokens delivered in the window keep up with
those offered (the window's requests' output tokens over its seconds; at
least 0.95 of them) and the backlog (requests sent and not finished)
grows over the window by no more than a tenth of the offered count. The cell's rate is fixed at 0.8 of the highest rate sustained. No
benchmark run calls this: it is a tool for a ``benchmark`` change that
must find a knee again.
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

from perfbench import harness  # noqa: E402
from perfbench.runners import serve  # noqa: E402


def backlog(reqs, t: float) -> int:
    return sum(q.due <= t and (q.finish is None or q.finish > t)
               for q in reqs if q.handle is not None)


def point(r) -> dict:
    w0, w1 = r.window
    window = [q for q in r.requests if q.phase == "window"]
    finished = sum(q.finish is not None and w0 <= q.finish < w1
                   for q in r.requests)
    offered_tok_s = sum(q.max_new for q in window) / (w1 - w0)
    row = {"rate_per_s": r.spec.cell["rate_per_s"],
           "offered": len(window), "finished_in_window": finished,
           "offered_tok_s": offered_tok_s,
           "backlog_open": backlog(r.requests, w0),
           "backlog_close": backlog(r.requests, w1),
           "failed": r.failed}
    for k, v in harness.metric_values(r).items():
        row[k] = v["value"]
    row["sustained"] = (row.get("output_tok_s", 0) >= 0.95 * offered_tok_s
                        and row["backlog_close"] - row["backlog_open"]
                        <= 0.1 * len(window))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--ramp", type=float, default=None,
                    help="seconds of arrivals before each window (default: "
                    "the cell's)")
    args = ap.parse_args(argv)
    import torch
    spec = harness.load_spec(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    base = harness.Run(spec=spec, seed=args.seed, seconds=args.seconds,
                       trace=False, device=dev, t_start=T_START)
    ctx = serve.setup(base)
    rows = []
    try:
        for rate in (float(x) for x in args.rates.split(",")):
            cell = {**spec.cell, "rate_per_s": rate}
            if args.ramp is not None:
                cell["ramp_s"] = args.ramp
            s = dataclasses.replace(spec, cell=cell)
            r = harness.Run(spec=s, seed=args.seed, seconds=args.seconds,
                            trace=False, device=dev, t_start=T_START)
            serve.measure(r, ctx)
            rows.append(point(r))
            print(json.dumps(rows[-1]), flush=True)
    finally:
        serve.teardown(base, ctx)
    ok = [row["rate_per_s"] for row in rows if row["sustained"]]
    print(json.dumps({"knee_per_s": max(ok) if ok else None,
                      "rate_per_s": 0.8 * max(ok) if ok else None,
                      "card": harness.card_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

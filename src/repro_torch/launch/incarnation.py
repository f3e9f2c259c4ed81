"""One serving incarnation for kill-and-recover checks.

Builds the engine on stablelm-1.6b in fp32 compute with seeded weights,
``recover()``s what an earlier incarnation left in ``--state-dir`` (printing
``REPLAYED <old id> <tokens>`` for each replayed request), then, unless
``--no-submit``, serves 4 new requests (ids 0..3 in submit order, printing
``DONE <id> <tokens>``), drains, closes and prints ``EXIT CLEAN``. Request
ids are process-local and deterministic, so an uncrashed run, a crashed one
and its recovery agree on them. Kill it with ``--fault-inject
crash_at:at=3`` (``os._exit(137)`` at the third chunk read-back) or a
SIGKILL, and run it again on the same state directory.

    python -m repro_torch.launch.incarnation --state-dir DIR [--device cpu]
        [--layers N] [--async] [--fault-inject SPEC] [--no-submit]

Without ``--layers`` the model is the smoke config (the CPU tests'); with
it, the full width cut to the first N layers (the weights are drawn at full
depth on the device from seed 0 and cut, as ``chip_smoke.py`` draws them).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..params import init_params
from ..serve.engine import ServeEngine

#: the 4 requests' prompt lengths and new tokens
PROMPT_LENS = (12, 9, 17, 14)
MAX_NEW = 16


def model(layers, device):
    """(cfg, params) in fp32 compute: the smoke config without ``layers``,
    else the full width cut to its first ``layers`` layers."""
    cfg = get_config("stablelm-1.6b")
    if layers is None:
        cfg = cfg.smoke()
    gen = torch.Generator(device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    if layers is not None:
        params = {k: ({kk: vv[:layers] for kk, vv in v.items()}
                      if isinstance(v, dict) else v)
                  for k, v in params.items()}
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = {k: ({kk: vv.float() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.float())
              for k, v in params.items()}
    return dataclasses.replace(cfg, compute_dtype="float32"), params


def prompts(vocab: int):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def engine(cfg, params, device, **kw):
    return ServeEngine(cfg, params, max_batch=2, decode_chunk=2,
                       kv_blocks=64, block_size=8, device=device, **kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--state-dir", required=True)
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it)")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--async", dest="async_decode", action="store_true")
    ap.add_argument("--fault-inject", default=None)
    ap.add_argument("--no-submit", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    else:
        torch.cuda.set_device(dev)
    cfg, params = model(args.layers, dev)
    eng = engine(cfg, params, dev, async_decode=args.async_decode,
                 fault_inject=args.fault_inject)
    replayed = eng.recover(args.state_dir)
    for old_id in sorted(replayed):
        out = eng.result(replayed[old_id], timeout=300.0)
        print("REPLAYED", old_id, ",".join(map(str, out.tolist())),
              flush=True)
    if not args.no_submit:
        reqs = [eng.submit(p, MAX_NEW) for p in prompts(cfg.vocab_size)]
        for r in reqs:
            out = eng.result(r, timeout=300.0)
            print("DONE", r.id, ",".join(map(str, out.tolist())),
                  flush=True)
    eng.drain(deadline_s=30.0)
    eng.close()
    print("EXIT CLEAN", flush=True)


if __name__ == "__main__":
    main()

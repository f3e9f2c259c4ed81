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
        [--mesh-model N]

``--mesh-model N`` serves on an N-rank ``gloo`` group: this process is
rank 0 (the engine, its journal and its fault injector), ranks 1..N-1 are
spawned on the same device (:class:`repro_torch.launch.mesh.TPSession`)
and their pids printed first as ``FOLLOWERS <pid>,...``. A crash of rank 0
ends them (:func:`repro_torch.launch.mesh.exit_with_parent`).

Without ``--layers`` the model is the smoke config (the CPU tests'); with
it, the full width cut to the first N layers (the weights are drawn at full
depth on the device from seed 0 and cut, as ``chip_smoke.py`` draws them).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
from typing import Optional

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


@dataclasses.dataclass(frozen=True)
class Model:
    """:func:`model` as a picklable builder (a spawned rank's weights)."""
    layers: Optional[int] = None

    def __call__(self, device):
        return model(self.layers, torch.device(device))


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
    ap.add_argument("--mesh-model", type=int, default=1, metavar="N",
                    help="serve on N gloo ranks on this device")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    else:
        torch.cuda.set_device(dev)
    cfg, params = model(args.layers, dev)
    with contextlib.ExitStack() as stack:
        tp = None
        if args.mesh_model > 1:
            from .mesh import TPSession
            s = stack.enter_context(TPSession(
                args.mesh_model, "gloo", Model(args.layers), dev))
            print("FOLLOWERS", ",".join(map(str, s.pids)),
                  flush=True)
            tp = s.tp
        serve(args, cfg, params, dev, tp)
    print("EXIT CLEAN", flush=True)


def serve(args, cfg, params, dev, tp) -> None:
    """Recover, then serve the new requests, drain and close."""
    eng = engine(cfg, params, dev, async_decode=args.async_decode,
                 fault_inject=args.fault_inject, tp=tp)
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


if __name__ == "__main__":
    main()

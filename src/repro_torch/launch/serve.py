"""Serving launcher of the port: the resident continuous-batching engine.

Requests are submitted one by one against the long-running pipeline
(``submit()``/``result()``); with ``--stagger`` they arrive spaced out, so
later requests join the batch while earlier ones are mid-decode. Runs on
CUDA; without a CUDA device it raises unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --preset full \
        --batch 8 --prompt-len 128 --max-new 32 --stagger 0.05
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen2-moe-a2.7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch falcon-mamba-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-1.2b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --trace /tmp/t.json --stats-interval 1
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --async-decode
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --deadline 0.5 --fault-inject 'alloc_fail:p=0.1,seed=1'
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --state-dir /tmp/sd --max-new 200 --decode-chunk 2 \
        --drain-deadline 1
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --per-call
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --mesh-model 2 --tp-backend gloo

Attention archs, dense and MoE, page their KV (``--kv-blocks``,
``--block-size``, ``--prefill-chunk``); Mamba1 archs and the zamba2 hybrid
keep one state per batch slot (``--max-seq-len`` bounds prompt + new
tokens, and sizes zamba2's shared-block KV span per slot). Weights are
random, drawn from ``--seed`` (``torch.Generator``).

``--stats-interval`` prints a one-line runtime summary every N seconds and
``--trace`` writes a Chrome trace-event JSON of the run (Perfetto); each
turns observability on, as ``REPRO_OBS=1`` does. ``REPRO_PREFIX_CACHE=1``
turns the prefix cache on (paged archs). ``--async-decode`` runs the decode
loop one chunk ahead (``REPRO_ASYNC_DECODE``; ``--no-async-decode`` forces
the synchronous path with the variable set); greedy tokens are the same.

SLO overload control and faults: ``--priority`` and ``--deadline`` apply to
every submitted request, ``--tier-target TIER=SHARE`` (repeatable),
``--shed-budget``, ``--watchdog`` and ``--fault-inject`` configure the
engine (each unset one defers to its environment variable). A request that
fails typed (shed at submit, past its deadline, a failed row) is counted
and printed; the run goes on.

Durability (as in the reference launcher): ``--state-dir DIR`` journals
every request transition to ``DIR/journal.wal`` (``--fsync-every``) and
recovers on start: the incomplete requests of an earlier run replay with
the same tokens, and a prior ``engine.snap`` warm-starts the prefix cache
(a corrupt one falls back cold, typed). SIGTERM drains (``--drain-deadline``
bounds it: past the deadline seated rows are checkpoint-preempted), then
snapshots, flushes the journal and exits 0; a clean exit leaves a snapshot
too. ``--per-call`` serves the prompts through the per-call grouped
baseline (``ServeEngine._generate_grouped``) instead of ``submit()``.

Tensor-parallel serving (``docs/sharded_serving.md`` in the reference):
``--mesh-model N`` runs this process as rank 0 of an N-rank group and
spawns ranks 1..N-1 (``torch.multiprocessing``, ``spawn``), each holding a
column slice of the attention and MLP weights and ``num_kv_heads / N``
heads of the paged pool; greedy tokens equal the single-device engine's.
``--tp-backend nccl`` puts rank r on ``cuda:r`` and raises with fewer than
N GPUs; ``gloo`` puts every rank on the launcher's device (one card, or
the CPU), its all-gathers staged through host memory. Unset,
``REPRO_MESH_MODEL=N`` asks for N ranks, clamped to the largest divisor
of the KV-head count (and to the GPUs, under ``nccl``); an explicit
indivisible ``--mesh-model`` raises ``MeshDivisibilityError``. SSM and
hybrid archs serve on rank 0 with the followers idle. The journal, state
directory, fault injection and the per-call baseline work under a group as
on one device; the decode chunk runs eagerly there (a captured chunk is
refused, ``TPUnsupported``).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import threading
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..distributed.sharding import validate_serve_mesh
from .mesh import ModelSpec, TPSession, env_mesh_model
from ..obs import Observability, StatsLogger
from ..params import init_params
from ..serve.engine import SNAPSHOT_FILE, ServeEngine
from ..serve.errors import ServeError


def main(argv=None):
    """Serve the prompts; returns each request's tokens (a numpy array
    apiece, in submission order; None for a request that failed typed)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help="model architecture of a family the port serves: "
                         "dense attention (e.g. stablelm-1.6b, qwen3-14b), "
                         "MoE (qwen2-moe-a2.7b, arctic-480b), Mamba1 SSM "
                         "(falcon-mamba-7b) or the Mamba2 hybrid "
                         "(zamba2-1.2b)")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per chunked-prefill window "
                         "(default: decode_chunk * block_size)")
    ap.add_argument("--kv-blocks", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=None,
                    help="slot-state (SSM, hybrid) archs: cap on prompt "
                         "+ new tokens per request (default 512)")
    ap.add_argument("--stagger", type=float, default=0.0,
                    help="seconds between submissions (0 = all at once)")
    ap.add_argument("--async-decode", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="async decode lookahead: device-resident carry and "
                         "one chunk dispatched ahead. Unset defers to "
                         "REPRO_ASYNC_DECODE; --no-async-decode forces the "
                         "synchronous path even with the variable set")
    ap.add_argument("--priority", type=int, default=0,
                    help="scheduling tier of the submitted requests "
                         "(0 = highest/SLO tier; larger = best-effort)")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-request deadline in seconds (expired "
                         "requests fail typed DeadlineExceeded)")
    ap.add_argument("--tier-target", action="append", default=None,
                    metavar="TIER=SHARE",
                    help="guaranteed minimum admission share for a tier "
                         "under sustained higher-tier load (repeatable, "
                         "e.g. --tier-target 1=0.25)")
    ap.add_argument("--shed-budget", type=float, default=None, metavar="S",
                    help="load-shedding queue-wait budget (seconds, all "
                         "tiers): submit() raises Overloaded when the "
                         "estimated wait exceeds it. Unset defers to "
                         "REPRO_SHED_BUDGET_S")
    ap.add_argument("--watchdog", type=float, default=None, metavar="S",
                    help="engine watchdog budget: fail all futures typed "
                         "WatchdogTimeout when a busy engine makes no "
                         "progress for S seconds. Unset defers to "
                         "REPRO_WATCHDOG_S")
    ap.add_argument("--fault-inject", default=None, metavar="SPEC",
                    help="deterministic fault-injection spec (see "
                         "repro_torch.serve.faultinject), e.g. "
                         "'grow_fail:p=0.05,seed=11'. Unset defers to "
                         "REPRO_FAULT_INJECT")
    ap.add_argument("--per-call", action="store_true",
                    help="serve through the per-call grouped baseline "
                         "instead of submit/result")
    ap.add_argument("--state-dir", default=None, metavar="DIR",
                    help="durability state directory: journal every "
                         "request transition to DIR/journal.wal, recover "
                         "(replay incomplete requests, warm-start the "
                         "prefix cache from DIR/engine.snap) on start, and "
                         "snapshot on SIGTERM or a clean exit")
    ap.add_argument("--drain-deadline", type=float, default=10.0,
                    metavar="S",
                    help="graceful-drain budget on SIGTERM: seated rows get "
                         "S seconds to finish before they are "
                         "checkpoint-preempted (default 10)")
    ap.add_argument("--fsync-every", type=int, default=1, metavar="N",
                    help="journal fsync cadence: every N records (1 = "
                         "every record, 0 = only at flush and close)")
    ap.add_argument("--mesh-model", type=int, default=None, metavar="N",
                    help="tensor-parallel ranks (this process is rank 0; "
                         "ranks 1..N-1 are spawned). Unset defers to "
                         "REPRO_MESH_MODEL (clamped)")
    ap.add_argument("--tp-backend", default="nccl", choices=("nccl", "gloo"),
                    help="torch.distributed backend of --mesh-model: nccl "
                         "(rank r on cuda:r) or gloo (every rank on this "
                         "process's device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--stats-interval", type=float, default=None,
                    help="print a one-line runtime stats summary every N "
                         "seconds (implies observability on)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON (Perfetto/"
                         "chrome://tracing) of the run (implies "
                         "observability on)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.preset == "smoke":
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    gen = torch.Generator(dev).manual_seed(args.seed)
    params = init_params(cfg, gen, device=dev)
    mesh = args.mesh_model
    if mesh is None:
        mesh = env_mesh_model(cfg, torch.cuda.device_count()
                              if args.tp_backend == "nccl" else None)
    session = contextlib.nullcontext()
    if mesh > 1:
        validate_serve_mesh(cfg, mesh)
        devices = None
        if args.tp_backend == "nccl":
            devices = [torch.device("cuda", r) for r in range(mesh)]
        session = TPSession(mesh, args.tp_backend,
                            ModelSpec(args.arch, args.preset, args.seed),
                            dev, devices=devices)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               .astype(np.int32) for _ in range(args.batch)]
    total_new = args.batch * args.max_new

    if cfg.ssm:
        geom = dict(max_seq_len=args.max_seq_len)
    else:
        geom = dict(prefill_chunk=args.prefill_chunk,
                    kv_blocks=args.kv_blocks, block_size=args.block_size)
    obs = Observability() \
        if (args.stats_interval is not None or args.trace) else None
    logger = None
    if args.stats_interval is not None:
        logger = StatsLogger(obs.metrics, interval=args.stats_interval)
    tier_targets = None
    if args.tier_target:
        tier_targets = {}
        for spec in args.tier_target:
            tier, _, share = spec.partition("=")
            tier_targets[int(tier)] = float(share)
    with session as tps, ServeEngine(
            cfg, params, decode_chunk=args.decode_chunk, device=dev,
            obs=obs, async_decode=args.async_decode,
            tier_targets=tier_targets, shed_budget_s=args.shed_budget,
            watchdog_s=args.watchdog, fault_inject=args.fault_inject,
            tp=tps.tp if tps is not None else None, **geom) as eng:
        if tps is not None:
            print(f"mesh: model axis = {mesh} ({args.tp_backend})",
                  flush=True)
        replayed = {}
        if args.state_dir:
            # crash or restart recovery: warm-start from an earlier
            # snapshot (a corrupt one falls back cold) and resubmit every
            # incomplete journaled request, then journal this run
            replayed = eng.recover(args.state_dir,
                                   fsync_every=args.fsync_every)
            if replayed or eng.stats["warm_started"]:
                print(f"recovered: {len(replayed)} incomplete request(s) "
                      f"replaying ({eng.stats['replayed_tokens']} prompt "
                      f"tokens), {eng.stats['warm_started']} warm prefix "
                      f"node(s)", flush=True)

        def _graceful(signum, frame):
            # drain off the signal frame: the main thread may be blocked in
            # result(), and drain and snapshot must not run there
            def run():
                print(f"SIGTERM: draining (deadline "
                      f"{args.drain_deadline:.1f}s)", flush=True)
                eng.drain(deadline_s=args.drain_deadline)
                if args.state_dir:
                    path = os.path.join(args.state_dir, SNAPSHOT_FILE)
                    print(f"snapshot: {eng.snapshot(path)} bytes -> {path}",
                          flush=True)
                eng.close()
                os._exit(0)
            threading.Thread(target=run, name="serve-drain",
                             daemon=True).start()
        signal.signal(signal.SIGTERM, _graceful)

        if logger is not None:
            logger.start()
        t0 = time.time()
        failed = []
        if args.per_call:
            outs = eng._generate_grouped(prompts, args.max_new)
        else:
            reqs = []
            for i, p in enumerate(prompts):
                try:
                    reqs.append(eng.submit(p, max_new=args.max_new,
                                           priority=args.priority,
                                           deadline_s=args.deadline))
                except ServeError as e:          # shed at submit
                    reqs.append(None)
                    failed.append((i, e))
                if args.stagger:
                    time.sleep(args.stagger)
            outs = []
            for i, r in enumerate(reqs):
                try:
                    outs.append(eng.result(r, timeout=600.0)
                                if r is not None else None)
                except ServeError as e:          # expired, failed row, ...
                    outs.append(None)
                    failed.append((i, e))
        for old_id, r in sorted(replayed.items()):
            out = eng.result(r, timeout=600.0)
            print(f"replayed request {old_id}: {len(out)} tokens",
                  flush=True)
        dt = time.time() - t0
        done = [o for o in outs if o is not None]
        gen = sum(len(o) for o in done)
        print(f"{cfg.name}: generated {gen} of {total_new} tokens in "
              f"{dt:.2f}s ({gen/dt:.1f} tok/s, batch={args.batch}, "
              f"device={dev}, "
              f"mode={'per-call' if args.per_call else 'continuous'}, "
              f"async_decode={eng.async_decode})")
        print("engine stats:", eng.stats)
        for i, e in sorted(failed, key=lambda f: f[0]):
            print(f"request {i} failed: {type(e).__name__}: {e}")
        if done:
            print("sample:", done[0][:16].tolist())
        if args.state_dir:
            # clean exit: settle and leave a warm snapshot for the next run
            eng.drain(deadline_s=args.drain_deadline)
            path = os.path.join(args.state_dir, SNAPSHOT_FILE)
            print(f"snapshot: {eng.snapshot(path)} bytes -> {path}")
        if logger is not None:
            logger.stop()
    if args.trace:
        obs.export(args.trace)
        print(f"trace written to {args.trace} "
              f"({len(obs.tracer)} spans; open at https://ui.perfetto.dev)")
    return outs


if __name__ == "__main__":
    main()

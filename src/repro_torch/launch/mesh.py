"""Process groups for tensor-parallel serving (the counterpart of
``repro.launch.mesh`` and of the serve engine's ``_env_mesh_ctx``).

The reference builds a device mesh inside one process; here each rank of
the model axis is a process. :func:`init_tp` joins this process to the
group (``torch.distributed``; ``nccl`` needs a GPU per rank, ``gloo`` may
put every rank on one device, or on the CPU) and returns its
:class:`repro_torch.distributed.TPGroup`. :func:`env_mesh_model` reads
``REPRO_MESH_MODEL``, clamped as the reference clamps it. :class:`TPSession`
makes the calling process rank 0 and spawns the others, each building the
same weights from a :class:`ModelSpec` and following rank 0's engines.
Nothing here picks a backend behind the caller's back.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Tuple

import torch

from ..distributed.sharding import TPGroup, serve_attn_sharded

__all__ = ["init_tp", "check_backend", "env_mesh_model", "BACKENDS",
           "OP_TIMEOUT_S", "IDLE_TIMEOUT_S", "ModelSpec", "TPSession",
           "follower_main", "free_init_method"]

BACKENDS = ("nccl", "gloo")
#: bound on one collective of the model (a rank that died or hung fails
#: the others' next op within this)
OP_TIMEOUT_S = 300.0
#: bound on a follower's wait for rank 0's next op descriptor, i.e. on
#: how long an engine may sit idle
IDLE_TIMEOUT_S = 7 * 24 * 3600.0


def env_mesh_model(cfg: Any, available: Optional[int] = None) -> int:
    """The model-axis size ``REPRO_MESH_MODEL=N`` asks for, CLAMPED as the
    reference's ``_env_mesh_ctx`` clamps it: to ``available`` ranks (the
    GPUs an ``nccl`` group can use; None for no bound), then down to the
    largest size that divides the config's KV-head, head and feature
    counts; 1 for SSM and hybrid archs (nothing to shard) and when the
    variable is unset. An explicit ``--mesh-model`` is never clamped: an
    indivisible one raises :class:`repro_torch.distributed.
    MeshDivisibilityError` in the engine."""
    env = os.environ.get("REPRO_MESH_MODEL", "").strip()
    if not env:
        return 1
    mp = int(env)
    if available is not None:
        mp = min(mp, available)
    if cfg.ssm or cfg.hybrid_attn_every:
        return 1
    while mp > 1 and not serve_attn_sharded(cfg, mp):
        mp -= 1
    return max(mp, 1)


def check_backend(world: int, backend: str) -> None:
    """Raise unless ``backend`` can run ``world`` ranks here: ``nccl``
    needs a GPU a rank."""
    if backend not in BACKENDS:
        raise ValueError(f"tensor-parallel backend {backend!r}: expected "
                         f"one of {BACKENDS}")
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"nccl tensor parallelism over {world} ranks needs {world} "
            f"GPUs, this machine has {torch.cuda.device_count()}; NCCL "
            "refuses two ranks on one GPU (--tp-backend gloo runs every "
            "rank on one card)")


def init_tp(world: int, rank: int, backend: str, init_method: str,
            device: Any = None) -> TPGroup:
    """Join the default process group as ``rank`` of ``world`` and return
    the serve :class:`TPGroup`: the model's all-gathers on the default
    group (``backend``), the op descriptors on a second, ``gloo`` group
    with an idle-length timeout (a follower waits there while the engine
    is idle). ``init_method``: a ``tcp://host:port`` or ``file://`` URL.
    ``device``: this rank's device (default ``cuda:rank`` for ``nccl``);
    ``nccl`` with fewer GPUs than ``world`` raises."""
    import torch.distributed as dist
    check_backend(world, backend)
    if backend == "nccl":
        device = device if device is not None else torch.device("cuda",
                                                                rank)
        torch.cuda.set_device(device)
    if device is None:
        raise ValueError("init_tp: a gloo rank needs its device")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=OP_TIMEOUT_S))
    desc = dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=IDLE_TIMEOUT_S))
    return TPGroup(rank, world, device, desc_group=desc)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A config and its seeded random weights, rebuilt the same on every
    rank (picklable, for spawned followers): ``arch`` at ``preset``
    (``smoke`` or ``full``) with the config fields of ``overrides``
    replaced (e.g. ``(("compute_dtype", "float32"), ("num_layers", 4))``),
    weights from ``torch.Generator(device).manual_seed(seed)``."""
    arch: str = "stablelm-1.6b"
    preset: str = "smoke"
    seed: int = 0
    overrides: Tuple[Tuple[str, Any], ...] = ()

    def config(self):
        from ..configs import get_config
        cfg = get_config(self.arch)
        if self.preset == "smoke":
            cfg = cfg.smoke()
        return dataclasses.replace(cfg, **dict(self.overrides))

    def __call__(self, device) -> Tuple[Any, Any]:
        from ..params import init_params
        dev = torch.device(device)
        return self.config(), init_params(
            self.config(), torch.Generator(dev).manual_seed(self.seed),
            device=dev)


def free_init_method() -> str:
    """A ``tcp://localhost:<port>`` rendezvous on a port free right now."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def follower_main(rank: int, world: int, backend: str, init_method: str,
                  device: Any, build, out, body=None) -> None:
    """A spawned follower rank: join the group, ``build()`` its
    ``(cfg, params)`` on ``device`` (a picklable callable: the same
    weights rank 0 builds), run ``body(cfg, params, tp)`` (default
    :func:`repro_torch.serve.tp.follow_engines`: follow rank 0's engines
    until :func:`repro_torch.serve.tp.release_followers`; each engine's
    report carries its kernel launches), then put ``{"rank", "result":
    body's result, "counters": the group's collectives}`` on ``out`` (a
    multiprocessing queue). A failure puts ``{"rank", "error":
    traceback}`` and exits 1."""
    import sys
    import traceback

    try:
        from ..serve.tp import follow_engines
        dev = torch.device(device) if device is not None else None
        tp = init_tp(world, rank, backend, init_method, dev)
        cfg, params = build(tp.device)
        result = (body or follow_engines)(cfg, params, tp)
        out.put({"rank": rank, "result": result,
                 "counters": tp.counters()})
        import torch.distributed as dist
        dist.destroy_process_group()
    except BaseException:                 # reported to rank 0, then exit 1
        tb = traceback.format_exc()
        print(f"[follower rank {rank}] failed:\n{tb}", file=sys.stderr,
              flush=True)
        out.put({"rank": rank, "error": tb})
        sys.exit(1)


class TPSession:
    """Rank 0 of a serve group, in this process, with ranks 1..world-1
    spawned (``spawn`` start method), each running :func:`follower_main`:
    ``with TPSession(...) as s:`` gives ``s.tp`` to build
    ``ServeEngine(tp=s.tp)`` on; leaving the block releases the
    followers, joins them (``timeout``; a failure, a follower that did
    not report or exited non-zero raises with their tracebacks, and one
    still running is terminated), keeps their reports in ``s.followers``
    and destroys the group. ``devices``: one device per rank (default:
    every rank on ``device``, as ``gloo`` may; ``nccl`` needs
    ``cuda:rank``); ``init_method``: default a free ``tcp://localhost``
    port; ``body``: the followers' work, which must end in
    ``follow_engines`` (the default)."""

    def __init__(self, world: int, backend: str, build, device: Any,
                 devices=None, init_method: Optional[str] = None,
                 body=None, timeout: float = 600.0) -> None:
        self.world, self.backend, self.build = world, backend, build
        self.device = torch.device(device)
        self.devices = list(devices) if devices is not None \
            else [self.device] * world
        self.init_method = init_method or free_init_method()
        self.body = body
        self.timeout = timeout
        self.tp: Optional[TPGroup] = None
        self.followers: list = []
        self._procs: list = []

    def __enter__(self) -> "TPSession":
        import torch.multiprocessing as mp
        check_backend(self.world, self.backend)
        ctx = mp.get_context("spawn")
        self._out = ctx.Queue()
        for rank in range(1, self.world):
            p = ctx.Process(target=follower_main, name=f"tp-rank{rank}",
                            args=(rank, self.world, self.backend,
                                  self.init_method, self.devices[rank],
                                  self.build, self._out, self.body),
                            daemon=True)
            p.start()
            self._procs.append(p)
        try:
            self.tp = init_tp(self.world, 0, self.backend,
                              self.init_method, self.devices[0])
        except BaseException:
            for p in self._procs:
                p.terminate()
            raise
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        import torch.distributed as dist
        from ..serve.tp import release_followers
        err = None
        try:
            if all(p.is_alive() for p in self._procs):
                release_followers(self.tp)
        except Exception as e:      # noqa: BLE001 — a follower died: the
            err = e                 # join below reports its traceback
        try:
            self.followers = self._join()
        finally:
            dist.destroy_process_group()
        if err is not None and exc_type is None:
            raise err

    def _join(self) -> list:
        import queue
        import time
        deadline = time.monotonic() + self.timeout
        got = {}
        while len(got) < len(self._procs):
            try:
                r = self._out.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                break
            got[r["rank"]] = r
        for p in self._procs:      # drained: the queue is empty
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        bad = []
        for rank, p in enumerate(self._procs, start=1):
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
                bad.append(f"rank {rank}: no result within "
                           f"{self.timeout:.0f} s (terminated)")
            elif "error" in got.get(rank, {}):
                bad.append(f"rank {rank}:\n{got[rank]['error']}")
            elif rank not in got or p.exitcode != 0:
                bad.append(f"rank {rank}: exit code {p.exitcode}")
        if bad:
            raise RuntimeError("tensor-parallel followers failed:\n"
                               + "\n".join(bad))
        return [got[r] for r in sorted(got)]

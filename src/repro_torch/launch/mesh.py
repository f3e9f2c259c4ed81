"""Process groups for tensor-parallel serving and sharded training (the
counterpart of ``repro.launch.mesh`` and of the serve engine's
``_env_mesh_ctx``).

The reference builds a device mesh inside one process; here each rank is a
process. Serving: :func:`init_tp` joins this process to the group
(``torch.distributed``; ``nccl`` needs a GPU per rank, ``gloo`` may put
every rank on one device, or on the CPU) and returns its
:class:`repro_torch.distributed.TPGroup`. :func:`env_mesh_model` reads
``REPRO_MESH_MODEL``, clamped as the reference clamps it. :class:`TPSession`
makes the calling process rank 0 and spawns the others, each building the
same weights from a :class:`ModelSpec` and following rank 0's engines.

Training: :func:`make_ctx` and :func:`small_mesh` are the reference's
(``dp`` over the ``pod``/``data`` axes, ``fsdp`` spanning them, ``tp`` and
``sp`` on ``model``), over a :class:`repro_torch.distributed.sharding.Mesh`
of ranks. :func:`mesh_ctx` builds this rank's
:class:`~repro_torch.distributed.sharding.MeshGroup` on a joined group, and
:class:`MeshSession` makes the calling process rank 0 of a group and
spawns the others, every rank running the same body (SPMD).

Nothing here picks a backend behind the caller's back, and every join and
collective has a timeout. A spawned rank whose rank 0 dies (a crash, a
SIGKILL, ``os._exit``) exits :data:`EXIT_RANK0_LOST` at once, wherever it
waits: a dead rank 0 ends the session, no follower is left behind.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Tuple

import torch

from ..distributed.sharding import (Mesh, MeshGroup, ShardCtx, TPGroup,
                                    serve_attn_sharded)

__all__ = ["init_tp", "check_backend", "env_mesh_model", "BACKENDS",
           "OP_TIMEOUT_S", "IDLE_TIMEOUT_S", "ModelSpec", "TPSession",
           "follower_main", "free_init_method", "make_ctx", "small_mesh",
           "join_group", "mesh_ctx", "MeshSession", "EXIT_RANK0_LOST",
           "exit_with_parent"]

BACKENDS = ("nccl", "gloo")
#: bound on one collective of the model (a rank that died or hung fails
#: the others' next op within this)
OP_TIMEOUT_S = 300.0
#: bound on a follower's wait for rank 0's next op descriptor, i.e. on
#: how long an engine may sit idle
IDLE_TIMEOUT_S = 7 * 24 * 3600.0
#: a spawned rank's exit code when its rank 0 is gone
EXIT_RANK0_LOST = 3


def exit_with_parent(rank: int) -> None:
    """In a spawned rank: a daemon thread that waits on the parent
    process (rank 0) and, once it is gone, exits this process with
    :data:`EXIT_RANK0_LOST` (``os._exit``: this rank may be blocked in a
    collective that would otherwise wait out the group's timeout)."""
    import multiprocessing as mp
    import sys
    import threading
    from multiprocessing.connection import wait

    parent = mp.parent_process()
    if parent is None:
        return

    def watch():
        wait([parent.sentinel])
        print(f"[rank {rank}] rank 0 (pid {parent.pid}) is gone: exiting "
              f"{EXIT_RANK0_LOST}", file=sys.stderr, flush=True)
        os._exit(EXIT_RANK0_LOST)

    threading.Thread(target=watch, name="rank0-watch", daemon=True).start()


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


def join_group(world: int, rank: int, backend: str, init_method: str,
               device: Any = None,
               timeout_s: float = OP_TIMEOUT_S) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` (every
    collective on it bounded by ``timeout_s``) and return this rank's
    device: ``device``, or ``cuda:rank`` for ``nccl`` when None (``nccl``
    with fewer GPUs than ``world`` raises; a ``gloo`` rank needs its
    device)."""
    import torch.distributed as dist
    check_backend(world, backend)
    if backend == "nccl" and device is None:
        device = torch.device("cuda", rank)
    if device is None:
        raise ValueError("a gloo rank needs its device")
    device = torch.device(device)
    if device.type == "cuda":     # this process's CUDA context, now
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device


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
    device = join_group(world, rank, backend, init_method, device)
    desc = dist.new_group(
        backend="gloo", timeout=datetime.timedelta(seconds=IDLE_TIMEOUT_S))
    return TPGroup(rank, world, device, desc_group=desc)


def make_ctx(mesh: Optional[Mesh], group: Optional[MeshGroup] = None
             ) -> ShardCtx:
    """ShardCtx with dp covering the (pod,) data axes and fsdp spanning
    them (parameter and optimizer shards scale with the total ranks);
    ``group``: this rank's :class:`MeshGroup` on ``mesh``."""
    if mesh is None:
        return ShardCtx(mesh=None)
    names = mesh.axis_names
    dp = tuple(n for n in ("pod", "data") if n in names)
    fsdp = dp if "data" in names else None
    if fsdp is not None and len(fsdp) == 1:
        fsdp = fsdp[0]
    return ShardCtx(mesh=mesh, dp=dp or ("data",), fsdp=fsdp,
                    tp="model" if "model" in names else None,
                    sp="model" if "model" in names else None, group=group)


def small_mesh(data: int = 2, model: int = 2) -> Mesh:
    """A (data, model) mesh of ``data * model`` ranks."""
    return Mesh((data, model), ("data", "model"))


def mesh_ctx(mesh: Mesh, device: Any,
             timeout_s: float = OP_TIMEOUT_S) -> Optional[ShardCtx]:
    """This rank's :func:`make_ctx` on ``mesh`` with its
    :class:`MeshGroup`, over world ranks ``0 .. mesh.size - 1`` of the
    joined default group. Collective: every rank of the group calls it
    with the same mesh (a rank off the mesh gets None)."""
    import torch.distributed as dist
    group = MeshGroup.create(mesh, dist.get_rank(), device, timeout_s)
    return None if group is None else make_ctx(mesh, group)


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

    exit_with_parent(rank)
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
        check_backend(self.world, self.backend)
        self._procs, self._out = _spawn(
            self.world, follower_main,
            lambda r: (self.world, self.backend, self.init_method,
                       self.devices[r], self.build), "tp",
            body=self.body)
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

    @property
    def pids(self) -> list:
        """The spawned ranks' process ids, rank 1 first."""
        return [p.pid for p in self._procs]

    def _join(self) -> list:
        return _join_ranks(self._procs, self._out, self.timeout,
                           "tensor-parallel followers")


def _spawn(world: int, target, args_of, name: str, **kwargs):
    """Ranks 1 .. world - 1 as ``spawn`` processes running ``target(rank,
    *args_of(rank), out=out, **kwargs)``; returns (processes, the queue
    ``out``)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = []
    for rank in range(1, world):
        p = ctx.Process(target=target, name=f"{name}-rank{rank}",
                        args=(rank, *args_of(rank)),
                        kwargs=dict(kwargs, out=out), daemon=True)
        p.start()
        procs.append(p)
    return procs, out


def _join_ranks(procs: list, out, timeout: float, what: str) -> list:
    """Collect each spawned rank's report from ``out`` and join it within
    ``timeout``; a rank that failed, did not report or exited non-zero
    raises with the tracebacks, and one still running is terminated."""
    import queue
    import time
    deadline = time.monotonic() + timeout
    got = {}
    while len(got) < len(procs):
        try:
            r = out.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue.Empty:
            break
        got[r["rank"]] = r
    for p in procs:      # drained: the queue is empty
        p.join(timeout=max(deadline - time.monotonic(), 1.0))
    bad = []
    for rank, p in enumerate(procs, start=1):
        if p.is_alive():
            p.terminate()
            p.join(timeout=5.0)
            bad.append(f"rank {rank}: no result within "
                       f"{timeout:.0f} s (terminated)")
        elif "error" in got.get(rank, {}):
            bad.append(f"rank {rank}:\n{got[rank]['error']}")
        elif rank not in got or p.exitcode != 0:
            bad.append(f"rank {rank}: exit code {p.exitcode}")
    if bad:
        raise RuntimeError(f"{what} failed:\n" + "\n".join(bad))
    return [got[r] for r in sorted(got)]


def mesh_rank_main(rank: int, world: int, backend: str, init_method: str,
                   device: Any, body, op_timeout_s: float, out) -> None:
    """A spawned rank of a :class:`MeshSession`: join the group, run
    ``body(device)`` and put ``{"rank", "result"}`` on ``out`` (the result
    pickled here, tensors with their data: a tensor put on the queue as
    is would be shared with rank 0 through this process, which exits); a
    failure puts ``{"rank", "error": traceback}`` and exits 1."""
    import pickle
    import sys
    import traceback

    exit_with_parent(rank)
    try:
        import torch.distributed as dist
        dev = join_group(world, rank, backend, init_method,
                         torch.device(device), op_timeout_s)
        out.put({"rank": rank, "result": pickle.dumps(body(dev))})
        dist.destroy_process_group()
    except BaseException:                 # reported to rank 0, then exit 1
        tb = traceback.format_exc()
        print(f"[mesh rank {rank}] failed:\n{tb}", file=sys.stderr,
              flush=True)
        out.put({"rank": rank, "error": tb})
        sys.exit(1)


class MeshSession:
    """Rank 0 of a ``world``-rank group in this process, with ranks 1 ..
    world - 1 spawned (``spawn`` start method), each running ``body(device)``
    (a picklable callable; SPMD: it builds its meshes with
    :func:`mesh_ctx` and trains on them). ``with MeshSession(...) as s:``
    joins the group; ``s.run()`` runs ``body`` here as rank 0. Leaving the
    block joins the others (``timeout``; a failure, a rank that did not
    report or exited non-zero raises with their tracebacks, and one still
    running is terminated; if rank 0 itself failed, its error is raised
    with theirs, each waited for 10 s), keeps their results in ``s.results`` after rank 0's, and
    destroys the group. ``devices``: one device per rank (default: every
    rank on ``device``, as ``gloo`` may; ``nccl`` needs ``cuda:rank``);
    ``op_timeout_s`` bounds every collective."""

    def __init__(self, world: int, backend: str, body, device: Any,
                 devices=None, init_method: Optional[str] = None,
                 timeout: float = 600.0,
                 op_timeout_s: float = OP_TIMEOUT_S) -> None:
        self.world, self.backend, self.body = world, backend, body
        self.devices = [torch.device(d) for d in devices] \
            if devices is not None else [torch.device(device)] * world
        self.init_method = init_method or free_init_method()
        self.timeout = timeout
        self.op_timeout_s = op_timeout_s
        self.results: list = []
        self._mine = None
        self._procs: list = []

    def __enter__(self) -> "MeshSession":
        check_backend(self.world, self.backend)
        self._procs, self._out = _spawn(
            self.world, mesh_rank_main,
            lambda r: (self.world, self.backend, self.init_method,
                       str(self.devices[r]), self.body, self.op_timeout_s),
            "mesh")
        try:
            join_group(self.world, 0, self.backend, self.init_method,
                       self.devices[0], self.op_timeout_s)
        except BaseException:
            for p in self._procs:
                p.terminate()
            raise
        return self

    def run(self) -> Any:
        """``body`` on rank 0 (this process); its result is kept."""
        self._mine = self.body(self.devices[0])
        return self._mine

    def __exit__(self, exc_type, exc, tb) -> None:
        import pickle

        import torch.distributed as dist
        try:
            if exc_type is not None:
                # rank 0 failed (often in a collective, a peer having
                # died): add the others' reports, waiting briefly
                try:
                    _join_ranks(self._procs, self._out, 10.0, "mesh ranks")
                except RuntimeError as others:
                    raise RuntimeError(f"mesh rank 0 failed: {exc!r}; "
                                       f"{others}") from exc
                return
            rest = _join_ranks(self._procs, self._out, self.timeout,
                               "mesh ranks")
            self.results = [self._mine] + [pickle.loads(r["result"])
                                           for r in rest]
        finally:
            dist.destroy_process_group()

"""Trainer-as-taskflow (torch port of ``repro.train.trainer``): the
training loop as the paper's conditional task graph, one cyclic graph on
the port's work-stealing :class:`repro_torch.core.Executor`.

    init ─> prefetch(host) ─> step(accel) ─> ckpt?(cond) ─┬─> save(host,
                 ^                                        │   detached)
                 │                                        v
                 └──────────────(0) loop(cond) <──────────┘
                                   │(1)
                                   v
                                  done

* ``prefetch`` arms the :class:`repro_torch.data.Prefetcher`, whose
  2-stage produce/stage ``DataPipeline`` runs on this executor's host
  workers, so batches are made while the device step runs;
* ``train-step`` runs on the ACCEL worker, bound to the trainer's device:
  one :func:`repro_torch.train.train_step.make_train_step` step. Metrics
  are read back to the host on ``log_every`` steps and on the last step
  only (each history entry adds ``step`` and ``time``, the host's
  ``perf_counter`` after the read); other steps do not wait for the
  device;
* ``ckpt?`` routes through ``ckpt-save`` every ``ckpt_every`` steps:
  the snapshot (a synchronous copy of params and optimizer state into host
  memory) is taken on the critical path, because the next step updates
  both in place; the write runs in a detached subflow;
* ``loop?`` closes the cycle.

Fault tolerance: a failed step cancels the topology; :meth:`Trainer.run`
restores the newest complete checkpoint and resubmits the graph, up to
``max_restarts`` times. ``fail_at_step`` injects one failure (tests).

Sharded (``ctx``: a :class:`repro_torch.distributed.sharding.ShardCtx`
with a mesh and this rank's ``MeshGroup``): one trainer per rank, every
rank running the same graph. Each draws the full weights from the seed
and keeps its blocks (:func:`repro_torch.train.elastic.reshard_state`);
each makes the global batch from the seed and the sharded step runs its
``dp`` rows, so no data crosses ranks. ``ckpt-save`` gathers the state
leaf by leaf into rank 0's host memory, rank 0 writes it and every rank
waits for the write (no detached write: a collective from a second
thread could interleave with the step's); a restore gives each rank its
blocks, whatever the rank count at save. With ``fail_at_step`` every rank
fails at that step and every rank restarts from the newest checkpoint.
Rank 0 keeps the history.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import ACCEL, HOST, Executor, TaskError, Taskflow
from ..data.pipeline import DataConfig, Prefetcher, SyntheticLM
from ..device import resolve_device
from ..distributed.sharding import ShardCtx
from ..optim.adamw import OptConfig, init_opt_state
from ..params import init_params
from ..tree import tree_map
from .checkpoint import CheckpointManager
from .elastic import reshard_state
from .train_step import make_train_step, opt_shardings, param_shardings

__all__ = ["TrainerConfig", "Trainer", "host_snapshot"]


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    prefetch_depth: int = 2
    max_restarts: int = 2
    microbatches: Optional[int] = 1
    fail_at_step: Optional[int] = None     # failure injection (tests)
    seed: int = 0


def host_snapshot(tree: Any) -> Any:
    """A synchronous copy of every leaf into host memory (a new tensor even
    for a CPU leaf: the next step updates the originals in place)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


class Trainer:
    """``device`` None means CUDA (and raises without it); the tests pass
    ``"cpu"``. Under a ``ctx`` with a mesh the device is its group's."""

    def __init__(self, cfg: ModelConfig, tc: TrainerConfig,
                 batch: int, seq_len: int,
                 opt: Optional[OptConfig] = None,
                 ckpt_dir: Optional[str] = None,
                 executor: Optional[Executor] = None,
                 device=None, ctx: Optional[ShardCtx] = None):
        self.cfg = cfg
        self.tc = tc
        self.opt = opt or OptConfig()
        self.ctx = ctx if ctx is not None and ctx.mesh is not None else None
        self.group = None
        self._shard = None
        if self.ctx is not None:
            self.group = self.ctx.group
            if self.group is None:
                raise ValueError("Trainer(ctx=): the ctx needs its "
                                 "MeshGroup (repro_torch.launch.mesh."
                                 "mesh_ctx)")
            device = self.group.device
            pshard = param_shardings(cfg, self.ctx)
            self._shard = {"params": pshard,
                           "opt": opt_shardings(cfg, self.ctx, pshard)}
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self._own_executor = executor is None
        self.executor = executor or Executor(
            domains={HOST: 2, ACCEL: 1}, devices={ACCEL: [self.device]})
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch,
            seed=tc.seed, frontend_tokens=(cfg.frontend_tokens if
                                           cfg.frontend != "none" else 0),
            d_model=cfg.d_model))
        self._step_fn = make_train_step(cfg, self.opt,
                                        microbatches=tc.microbatches,
                                        ctx=self.ctx)
        self.history: List[Dict[str, float]] = []
        self._failed_once = False

    # ------------------------------------------------------------------ state
    def init_state(self) -> Dict[str, Any]:
        """fp32 masters (``param_dtype``) drawn from a ``torch.Generator``
        on the trainer's device, seeded with ``tc.seed``; zero moments."""
        g = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = init_params(self.cfg, g, device=self.device, cast=False)
        if self.ctx is not None:     # keep this rank's blocks
            params = reshard_state(self.cfg, {"params": params},
                                   self.ctx)["params"]
        return {"params": params, "opt": init_opt_state(params, self.opt),
                "step": 0}

    def _restore_latest(self, state: Dict[str, Any]) -> Optional[int]:
        if self.group is not None:    # every rank sees the same newest one
            self.group.barrier()
        s, restored = self.ckpt.restore_latest(
            {"params": state["params"], "opt": state["opt"]}, self.device,
            self._shard, None if self.ctx is None else self.ctx.rank)
        if s is not None:
            state["params"] = restored["params"]
            state["opt"] = restored["opt"]
            state["step"] = s
        return s

    # ------------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        try:
            state = self.init_state()
            if self.ckpt is not None:
                self._restore_latest(state)
            restarts = 0
            while True:
                try:
                    self._run_taskflow(state)
                    break
                except TaskError:
                    restarts += 1
                    if restarts > self.tc.max_restarts or self.ckpt is None:
                        raise
                    if self._restore_latest(state) is None:
                        state = self.init_state()
        finally:
            if self._own_executor:
                self.executor.shutdown()
        return {"state": state, "history": self.history,
                "restarts": restarts}

    def _device_scope(self):
        return torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":   # pinned: the copy waits for no
            # earlier work, so the host enqueues the step without a sync
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ------------------------------------------------- the conditional TDG
    def _run_taskflow(self, state: Dict[str, Any]) -> None:
        tc = self.tc
        prefetcher = Prefetcher(self.data.batch_at, tc.prefetch_depth,
                                start_step=state["step"],
                                executor=self.executor)
        tf = Taskflow("trainer")

        t_init = tf.static(lambda: None, name="init")
        t_prefetch = tf.static(prefetcher.start, name="prefetch",
                               domain=HOST)

        def device_step():
            step = state["step"]
            if tc.fail_at_step is not None and step == tc.fail_at_step \
                    and not self._failed_once:
                self._failed_once = True
                raise RuntimeError(f"injected failure at step {step}")
            _, batch = prefetcher.get()
            with self._device_scope():
                batch = {k: self._to_device(v) for k, v in batch.items()}
                params, opt_state, metrics = self._step_fn(
                    state["params"], state["opt"], batch)
                state["params"], state["opt"] = params, opt_state
                state["step"] = step + 1
                if (step % tc.log_every == 0
                        or step + 1 == tc.total_steps) and \
                        (self.group is None or self.group.rank == 0):
                    names = sorted(metrics)
                    vals = torch.stack([metrics[k].float() for k in names])
                    m = dict(zip(names, vals.tolist()))   # the one sync
                    m["step"] = step
                    m["time"] = time.perf_counter()   # the step has ended
                    self.history.append(m)

        t_step = tf.static(device_step, name="train-step", domain=ACCEL)

        def ckpt_due() -> int:
            due = (self.ckpt is not None
                   and state["step"] % tc.ckpt_every == 0)
            return 0 if due else 1

        t_ckpt_cond = tf.condition(ckpt_due, name="ckpt?")

        def save(sf):
            step = state["step"]
            if self.group is not None:   # rank 0 writes, the others wait
                self._save_sharded(step, state)
                return
            # snapshot on the critical path, write detached (async ckpt)
            snap = host_snapshot({"params": state["params"],
                               "opt": state["opt"]})
            sf.static(lambda: self.ckpt.save(step, snap), name="ckpt-write")
            sf.detach()

        t_save = tf.dynamic(save, name="ckpt-save", domain=HOST)

        def loop() -> int:
            return 1 if state["step"] >= tc.total_steps else 0

        t_loop = tf.condition(loop, name="loop?")
        t_done = tf.static(lambda: prefetcher.stop(), name="done")

        t_init.precede(t_prefetch)
        t_prefetch.precede(t_step)
        t_step.precede(t_ckpt_cond)
        t_ckpt_cond.precede(t_save, t_loop)   # 0 -> save, 1 -> skip
        t_save.precede(t_loop)
        t_loop.precede(t_prefetch, t_done)    # 0 -> continue, 1 -> done

        self.executor.run(tf).wait()
        if self.ckpt is not None and state["step"] >= tc.total_steps:
            if self.group is not None:
                self._save_sharded(state["step"], state)
            else:
                self.ckpt.save(state["step"],
                               host_snapshot({"params": state["params"],
                                              "opt": state["opt"]}))

    def _save_sharded(self, step: int, state: Dict[str, Any]) -> None:
        with self._device_scope():
            self.ckpt.save_sharded(
                step, {"params": state["params"], "opt": state["opt"]},
                self._shard, self.group)

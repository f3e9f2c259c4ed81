"""Data pipeline: deterministic synthetic LM token streams with host-side
prefetch driven by the taskflow runtime (a copy of
``repro.data.pipeline``, numpy only, on the port's own
:class:`repro_torch.pipeline.DataPipeline` and executor; ``batch_at(step)``
gives the reference's arrays bit for bit).

At production scale the host-domain workers of the paper's executor overlap
batch preparation with the device step (the work-stealing scheduler is what
the paper contributes; the pipeline is one of its natural clients). Each
data shard is seeded by (seed, shard_index, step) so restarts are exactly
reproducible and elastic re-sharding keeps determinism per global example.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np

from ..pipeline import DataPipe, DataPipeline, PipeType

__all__ = ["DataConfig", "SyntheticLM", "Prefetcher"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    d_model: int = 0


class SyntheticLM:
    """Zipf-ish synthetic token stream with learnable n-gram structure
    (a bigram process, so a real model shows decreasing loss)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        k = min(64, V)
        # sparse bigram transition structure
        self._next = rng.integers(0, V, size=(V, k)).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S), np.int32)
        cur = rng.integers(0, cfg.vocab_size, size=B)
        # skewed transitions: successor 0 with prob 0.75, else uniform over
        # the k successors — H* ~ 1.6 nats, so a model that learns the
        # primary bigram map drops far below the uniform floor ln(V)
        k = self._next.shape[1]
        choice = np.where(rng.random((B, S)) < 0.75, 0,
                          rng.integers(0, k, size=(B, S))).astype(np.int64)
        for t in range(S):
            toks[:, t] = cur
            cur = self._next[cur, choice[:, t]]
        out = {"tokens": toks}
        if cfg.frontend_tokens:
            out["frontend_embeds"] = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        return out


class Prefetcher:
    """Bounded prefetch implemented as a 2-stage task-parallel pipeline.

    The prefetch loop is the canonical Pipeflow client: a **produce** stage
    (SERIAL — ``source(step)`` is called strictly in step order, safe for
    stateful sources) followed by a **stage** stage (PARALLEL — results are
    staged into the consumer queue concurrently, re-ordered by step so
    :meth:`get` always yields batches in order).

    Two drive modes share one credit-based core (``_claim``/``_emit``):

    * **manual** — :meth:`produce_one` pushes one token through both stages
      inline; this is the task body the trainer's taskflow schedules on host
      workers. Non-blocking: returns ``False`` when the queue is full or the
      prefetcher is stopped, so a detached prefetch task can never wedge a
      worker (liveness of the trainer topology).
    * **executor** — pass ``executor=``; the prefetcher owns a
      :class:`repro_torch.pipeline.DataPipeline` whose SERIAL first pipe claims
      steps and materialises batches while the PARALLEL second pipe stages
      them. When the bounded queue fills, the first pipe calls ``pf.stop()``
      and the pipeline *drains* (back-pressure without blocked workers);
      :meth:`get` re-arms it once capacity frees up.

    Public API (``produce_one`` / ``get`` / ``stop`` / ``qsize``) is
    unchanged from the thread-queue implementation it replaces.
    """

    def __init__(self, source, depth: int = 2, start_step: int = 0,
                 executor=None):
        self._source = source
        self._depth = depth
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._next = start_step
        self._emit_next = start_step
        self._ready: Dict[int, Any] = {}   # out-of-order staging buffer
        self._inflight = 0                 # claimed but not yet queued
        self._lock = threading.Lock()
        self._stopped = False
        self._executor = executor
        self._topo = None
        self._pump_lock = threading.Lock()
        self._pipeline = None
        if executor is not None:
            self._pipeline = DataPipeline(
                max(1, depth),
                DataPipe(PipeType.SERIAL, self._pipe_produce, name="produce"),
                DataPipe(PipeType.PARALLEL, self._pipe_stage, name="stage"),
                name="prefetch")

    # ------------------------------------------------------ credit-based core
    def _claim(self) -> Optional[int]:
        """Reserve the next step, bounded by queue capacity; None when full
        or stopped. qsize + inflight never exceeds depth, so staging a
        claimed batch can never block."""
        with self._lock:
            if self._stopped or self._inflight + self._q.qsize() >= self._depth:
                return None
            step = self._next
            self._next += 1
            self._inflight += 1
            return step

    def _emit(self, step: int, batch) -> None:
        """Stage a materialised batch; releases to the queue in step order."""
        with self._lock:
            self._ready[step] = batch
            while self._emit_next in self._ready:
                self._q.put_nowait(
                    (self._emit_next, self._ready.pop(self._emit_next)))
                self._emit_next += 1
                self._inflight -= 1

    # -------------------------------------------------------- pipeline stages
    def _pipe_produce(self, pf):
        step = self._claim()
        if step is None:
            pf.stop()  # full or stopped: drain (back-pressure, no blocking)
            return None
        return step, self._source(step)

    def _pipe_stage(self, pf, item):
        self._emit(*item)
        return None

    def _pump(self) -> bool:
        """Re-arm the drained pipeline if there is capacity to fill. Also
        installed as the pipeline's on_complete hook: a topology that drains
        in the instant the consumer empties the queue restarts itself, so a
        blocked :meth:`get` can never strand free capacity."""
        if self._executor is None:
            return False
        with self._pump_lock:
            if self._topo is not None and not self._topo.done():
                return True
            with self._lock:
                idle = (self._stopped or
                        self._inflight + self._q.qsize() >= self._depth)
            if idle:
                return False
            self._topo = self._pipeline.run(self._executor,
                                            lambda _topo: self._pump())
            return True

    # ------------------------------------------------------------- public API
    def start(self) -> bool:
        """Kick the executor-driven pipeline (no-op in manual mode)."""
        return self._pump()

    def produce_one(self) -> bool:
        """One prefetch token pushed through both stages inline (manual
        drive). Non-blocking; False when full or stopped."""
        step = self._claim()
        if step is None:
            return False
        self._emit(step, self._source(step))
        return True

    def get(self, timeout: Optional[float] = 60.0):
        self._pump()  # arm the producer before blocking on an empty queue
        item = self._q.get(timeout=timeout)
        self._pump()  # consumed one slot: refill ahead of the consumer
        return item

    def qsize(self) -> int:
        return self._q.qsize()

    def stop(self) -> None:
        self._stopped = True

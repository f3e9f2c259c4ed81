"""Continuously-batched serving engine of the port: a RESIDENT 4-stage
Taskflow pipeline fed by a request queue, with TWO-PHASE memory admission.

This is the single-device subset of the reference
``repro.serve.engine.ServeEngine``, with the same stage structure. Attention
archs, MoE included, page their KV (below); Mamba1 archs (falcon-mamba) and
the zamba2 hybrid keep a FIXED-SLOT recurrent-state pool instead (``paged ==
False``, see "Slot-state path"):

    admit (SERIAL)    -> pop an admission group (one FIFO, tiered) and
                         allocate its PROMPT-ONLY block footprint; park via
                         ``pf.defer(token)`` when the head does not fit, or
                         emit a plain decode-pump cycle
    prefill (SERIAL)  -> one launch for the group's FIRST prompt window
                         (prompts right-padded to a power-of-two window);
                         on CUDA its attention is K2, the flash kernel
    decode (SERIAL,   -> merge the group (scatter window-0 KV into the pool,
      accel domain)      assign slots), stream ONE more prefill window for
                         every mid-prefill row, grow block tables lazily for
                         rows about to cross a block boundary (preempting
                         the cost-model victim on pool exhaustion), then
                         advance every decoding row by one chunk of
                         ``decode_chunk`` steps (K1 on CUDA)
    complete (PARALLEL)-> retire finished rows: fulfil their futures, free
                         their blocks and slots

The KV pool and the device block tables are written ONLY by the SERIAL
decode stage, in place (the reference donates and replaces them). The
chunk's only device sync is reading its tokens back.

The decode chunk is one program (:class:`repro_torch.serve.chunk_graph.
ChunkProgram`, the counterpart of the reference's jitted chunk): on CUDA
the engine captures it once, in the constructor, as a CUDA graph over its
static tensors (pool or slot state, device tables, weights, a ``(3, B)``
carry and a ``(B, n + 3)`` output) and every chunk is one replay. On the
CPU the same body runs eagerly; ``chunk_graph=False`` asks for the eager
chunk on CUDA too (the oracle of the card's tests). A failed capture
raises.

Async decode lookahead (``async_decode=`` / ``REPRO_ASYNC_DECODE``, off by
default as in the reference): the decode stage is split into dispatch ->
sync at a depth of 2. The carry stays on the device across chunks (chunk
N+1 reads chunk N's advanced carry in place) and the engine writes rows of
it with :func:`repro_torch.serve.kvcache.set_carry_rows` at admission,
window completion, retirement and preemption; the host keeps exact
``lengths``/``rem`` mirrors by arithmetic (a chunk's advance does not
depend on its tokens) while ``last`` lives on the device only. Each cycle
merges, streams prefill windows and grows tables, dispatches chunk N+1,
then waits for chunk N's tokens and does the bookkeeping while N+1 runs.
Retirement is one chunk late (a finished row is masked by ``rem == 0`` in
the chunk in flight); a per-slot seat generation discards tokens a chunk
computed for a row whose seat changed since its dispatch; a preempted
row's blocks (and a copy-on-write original's reference) pass the pool's
deferred-free fence, released two synced chunks later; a prefill window
completes one cycle after its launch. No copy after the dispatch waits for
the chunk in flight: uploads go through pinned staging, token and first-
token reads land in pinned memory behind events
(:class:`repro_torch.serve.chunk_graph.HostLink`), and on CUDA the prefill
stage runs on its own stream, which the decode stage waits on (an event)
before the merge's scatters read its output.

Slot-state path (Mamba1, hybrid): the pool is :func:`repro_torch.models.
lm.init_cache`'s state for ``max_batch`` slots, allocated once: per-layer
``(conv, h)`` (Mamba1: ``ssm``; zamba2: ``g_ssm`` and ``tail_ssm``) and,
for zamba2, each group's shared-block KV span of ``max_seq_len`` positions
per slot (``shared_k``, ``shared_v``). Admission is bounded by free slots
alone (a slot's state is sized once, so there are no blocks, windows,
growth or preemption); the prefill stage runs one whole-prompt prefill per
member at B=1 (on CUDA, Mamba1's scans are K3, the selective-scan kernel,
and zamba2's shared-block attention is K2); the decode stage copies each
member's prefilled state into its slot and advances every row with
:func:`repro_torch.models.lm.decode_chunk_slots`, which updates the slot
state in place. ``max_seq_len`` (default 512) bounds ``prompt + max_new``
at submit, as in the reference, which keeps every zamba2 row's KV write
inside its span.

Threads: the stages run on :class:`repro_torch.core.Executor` worker
threads, and ``torch.inference_mode`` is thread-local, so every stage
enters it (and the engine's CUDA device) itself.

SLO overload control (as in the reference): ``submit(deadline_s=)`` bounds
a request's latency (it fails typed :class:`DeadlineExceeded` whether it is
queued or seated), :meth:`ServeRequest.cancel` withdraws it from any state,
``shed_budget_s`` rejects a submit typed :class:`Overloaded` when the
service-rate estimate of its queue wait exceeds the tier's budget,
``tier_targets`` reserves admission shares for best-effort tiers, and the
admission head fails a deadline it cannot meet at the observed rate before
it takes a slot. Every cycle the decode stage sweeps the seated rows
(:meth:`ServeEngine._sweep_seated`): cancelled and expired rows are
evicted through the preemption path's frees (the fence, async) and a
waiting head of a better tier than the worst seated row preempts it when
every slot is taken.

Failure isolation: a raising prefill fails only its admitted group
(:class:`RowFailed`); a raising decode stage (merge, window, growth, the
chunk or its read-back) fails every seated and admitted-but-unmerged row
typed :class:`RowFailed` and resets the device state IN PLACE (``zero_()``
on the same pool or slot state, tables and carry, after a device
synchronize that orders it behind every queued write; a fresh host
``BlockPool`` and ``PrefixCache``): the reference rebuilds its pool because
the failed jitted call donated it, while the captured chunk here bakes in
those tensors' addresses, so a fresh allocation would make every later
replay raise. A reset epoch keeps groups admitted and rows retired before
the reset from seating or freeing against the new state. A sticky CUDA
error (an illegal address) cannot be isolated: the synchronize raises
again and the engine goes broken, failing every future. ``watchdog_s``
runs a daemon thread that fails every future typed
:class:`WatchdogTimeout` when a busy engine makes no stage progress for
that long (it cannot interrupt a replay or a blocked read-back; ``result()``
raises instead of hanging). An exception in the admit or complete stage
cancels the pipeline topology, fails every outstanding future and marks
the engine broken. ``fault_inject`` (:mod:`repro_torch.serve.faultinject`,
``REPRO_FAULT_INJECT``) reaches these paths on demand: ``alloc_fail`` at
admission, ``evict``/``preempt``/``grow_fail`` at growth, and
``chunk_latency``/``chunk_sync_exc``/``crash_at`` at the chunk's read-back.
The reference consults ``preempt`` in its paged growth pass only; the port
also consults it on the slot-state path, once per cycle with a seated row,
so that a Mamba1 or zamba2 row's checkpoint preemption can be forced
(synchronous engine: the slot's state is copied to host memory and
re-seated exactly, with no prefill; async: the row replays from its
prompt, as in the reference). A paged row replays from its prompt, so
under ``preempt:every=N`` a row that needs N or more cycles alone is
preempted forever, in the reference as here.

Prefix caching (``prefix_cache=`` / ``REPRO_PREFIX_CACHE``, paged archs
only, off by default): full prompt chunks are indexed in a
:class:`repro_torch.serve.prefix.PrefixCache` trie; a cache-hit admission
budgets and prefills only its uncached suffix (it takes no window-0 row:
its windows start at the first uncached token, which need not be a
multiple of the block or the window), seats its table with the shared,
refcount-pinned blocks, and forks a partially matched tail block copy-on-
write (:func:`repro_torch.serve.kvcache.copy_blocks`) before its own writes
land in it. Under pool pressure, parked prefix blocks are evicted by reuse
score before any row is preempted, and ``_cow_guard`` forks any block
still shared that a row is about to write.

Observability (``obs=`` / ``REPRO_OBS``, off by default): request
lifecycle spans on ``slotN`` tracks, cycle phases on the ``engine`` track,
the pipeline's pipe bodies on ``lineN`` tracks, and the metrics of
:mod:`repro_torch.obs` (TTFT, queue wait, per-cycle dispatch / sync /
bookkeeping / gap seconds, pool and queue gauges). On CUDA
``engine.dispatch_s`` is host enqueue time (the carry copy and one replay,
or the eager chunk's launches) and ``engine.chunk_sync_s`` the wait at the
chunk's only sync, the token read-back; the engine adds no synchronisation
for them. ``engine.gap_s`` is host time with no chunk in flight. Disabled,
each site costs one ``is None`` check.

Not in this slice (queued in ROADMAP.md): journal/snapshot/drain/recover
(with the sweep's drain branch and the ``snapshot_corrupt`` site), meshes
and the per-call grouped baseline. The engine raises
:class:`UnsupportedArch` on archs it cannot serve yet (modality
frontends).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import ACCEL, HOST, Executor
from ..device import resolve_device
from ..kernels.ops import PAGED_IMPLS, default_paged_impl, ensure_built
from ..models import lm
from ..obs import TRACK_ENGINE
from ..obs import from_env as _obs_from_env
from ..pipeline import DataPipe, DataPipeline, PipeType
from .chunk_graph import ChunkProgram, HostLink
from .errors import (DeadlineExceeded, EngineClosed, Overloaded,
                     RequestCancelled, RowFailed, ServeError,
                     WatchdogTimeout)
from .faultinject import FaultInjected, FaultInjector
from .kvcache import (BlockPool, copy_blocks, extend_block_tables,
                      init_kv_pool, scatter_prefill_rows, set_carry_rows,
                      set_table_rows)
from .prefix import PrefixCache
from .scheduler import Scheduler, ServeRequest

__all__ = ["ServeEngine", "ServeRequest", "UnsupportedArch"]

#: pipeline lines (cycles in flight) of the resident admit/prefill/decode/
#: complete pipeline, as in the reference engine's default
PIPELINE_LINES = 3


class UnsupportedArch(ServeError, ValueError):
    """The port's engine cannot serve this architecture yet
    (modality-frontend configs come with a later slice)."""


class ServeEngine:
    """Resident continuous-batching engine (see module docstring).

    Parameters
    ----------
    cfg, params:
        a dense attention, MoE, Mamba1 or zamba2 hybrid config and its
        weights (:func:`repro_torch.params.init_params` /
        ``from_reference``) on the engine's device.
    decode_chunk:
        decode steps per chunk — also the admission granularity.
    prefill_chunk:
        prompt tokens per prefill window (default ``decode_chunk *
        block_size``); longer prompts stream their remaining windows
        through the decode stage while resident rows keep decoding. Paged
        path only.
    max_batch:
        decode slot count; the chunk always runs this many rows (inactive
        rows masked).
    kv_blocks / block_size:
        paged KV pool geometry. Block 0 is the reserved sink. Paged path
        only.
    max_admit:
        cap on requests admitted per cycle (one prefill launch).
    max_seq_len:
        per-sequence cap on ``prompt + max_new``. Paged: sets the
        block-table width; defaults to 32 blocks worth, clamped to the pool
        size. Slot-state: defaults to 512.
    paged_impl:
        decode read path: ``"kernel"`` (K1 on CUDA), ``"loop"`` (plain page
        loop) or ``"gather"`` (materializing oracle). None resolves via
        :func:`repro_torch.kernels.ops.default_paged_impl` (honours
        ``REPRO_PAGED_IMPL``; kernel on CUDA, loop on the CPU). Window-0
        prefill attention follows the device: K2 (``flash``) on CUDA, the
        reference's ``chunked`` path on the CPU. None on the slot-state
        path.
    prefix_cache:
        share KV blocks across requests with a common prompt prefix (see
        the module docstring). None resolves via ``REPRO_PREFIX_CACHE``
        (default off: the uncached path is the reference). Paged archs
        only; ignored on the slot-state path.
    async_decode:
        pipeline the decode loop one chunk deep (see the module
        docstring). None resolves via ``REPRO_ASYNC_DECODE`` (default off:
        the synchronous path is the reference).
    chunk_graph:
        run the decode chunk as a captured CUDA graph (None: on CUDA, the
        default) or eagerly (False; the CPU always runs it eagerly, and
        True there raises).
    tier_targets:
        per-tier guaranteed minimum share of each admission cycle
        (``{tier: share}``, see :class:`repro_torch.serve.scheduler
        .Scheduler`): the floor that keeps best-effort tiers from starving.
    shed_budget_s:
        load-shedding budget: a float for every tier or ``{tier:
        budget_s}`` (absent tiers are never shed). ``submit()`` raises
        :class:`Overloaded` when the estimated queue wait exceeds it (or the
        request's own ``deadline_s``): the resident rows' remaining steps
        plus the ``max_new`` waiting at tiers <= the request's, over the
        EWMA of emitted tokens per cycle second; before the first tokens,
        the p90 of ``serve.queue_wait_s`` scaled by the backlog (after 8
        admissions; needs ``obs``). None resolves via
        ``REPRO_SHED_BUDGET_S`` (default off).
    watchdog_s:
        fail every future typed :class:`WatchdogTimeout` when a busy engine
        makes no stage progress for this long. 0/None is off; None resolves
        via ``REPRO_WATCHDOG_S``.
    fault_inject:
        a :class:`repro_torch.serve.faultinject.FaultInjector` or its spec
        string (seeded faults at named sites). None resolves via
        ``REPRO_FAULT_INJECT`` (default off).
    record_stages:
        keep an in-memory (stage, cycle-token, info, t) event log.
    obs:
        a :class:`repro_torch.obs.Observability` (tracer + metrics
        registry). None resolves via ``REPRO_OBS`` (default off).
        Rebindable at idle via :meth:`set_obs`.
    device:
        None means CUDA and raises when no CUDA device is present; pass
        ``"cpu"`` for the plain PyTorch path.
    """

    def __init__(self, cfg: ModelConfig, params,
                 decode_chunk: int = 8,
                 prefill_chunk: Optional[int] = None,
                 max_batch: int = 8,
                 kv_blocks: int = 128,
                 block_size: int = 16,
                 max_admit: int = 4,
                 max_seq_len: Optional[int] = None,
                 paged_impl: Optional[str] = None,
                 prefix_cache: Optional[bool] = None,
                 async_decode: Optional[bool] = None,
                 chunk_graph: Optional[bool] = None,
                 tier_targets: Optional[Dict[int, float]] = None,
                 shed_budget_s=None,
                 watchdog_s: Optional[float] = None,
                 fault_inject=None,
                 record_stages: bool = False,
                 obs=None,
                 device=None):
        if cfg.frontend != "none":
            raise UnsupportedArch(
                f"{cfg.name} (family {cfg.family!r}, frontend "
                f"{cfg.frontend!r}): the repro_torch engine serves dense "
                "attention, MoE, Mamba1 and Mamba2-hybrid archs only in "
                "this slice")
        self.cfg = cfg
        self.paged = not (cfg.ssm or cfg.hybrid_attn_every)
        self.device = resolve_device(device)
        for name, t in _leaves(params):
            if t.device != self.device:
                raise ValueError(f"param {name} is on {t.device}, the "
                                 f"engine on {self.device}")
        if self.device.type == "cuda":
            # build the kernels here, on the caller's thread, never inside
            # a pipeline worker
            ensure_built(self.device.index)
        self.params = params
        # per-layer weight views, built once for every step of this engine
        self._layers = lm.layer_views(params)
        self.decode_chunk = decode_chunk
        self._executor: Optional[Executor] = None
        if paged_impl is not None and paged_impl not in PAGED_IMPLS:
            raise ValueError(f"paged_impl={paged_impl!r}: expected one of "
                             f"{PAGED_IMPLS} (or None for the default)")
        self.paged_impl = (paged_impl or default_paged_impl(self.device)) \
            if self.paged else None
        if prefix_cache is None:
            prefix_cache = os.environ.get("REPRO_PREFIX_CACHE", "") \
                .strip().lower() in ("1", "true", "yes", "on")
        #: cross-request KV block sharing (paged archs only)
        self.prefix_cache = bool(prefix_cache) and self.paged
        if async_decode is None:
            async_decode = os.environ.get("REPRO_ASYNC_DECODE", "") \
                .strip().lower() in ("1", "true", "yes", "on")
        #: dispatch -> sync pipelined decode loop (depth 2); False = the
        #: synchronous reference path
        self.async_decode = bool(async_decode)
        cuda = self.device.type == "cuda"
        if chunk_graph is None:
            chunk_graph = cuda
        self._closing = False
        self._broken: Optional[BaseException] = None
        self._stage_log = [] if record_stages else None
        self._log_lock = threading.Lock()
        # deterministic fault injection (argument > environment)
        if fault_inject is None:
            fault_inject = os.environ.get("REPRO_FAULT_INJECT") or None
        if isinstance(fault_inject, str):
            fault_inject = FaultInjector.parse(fault_inject)
        self._fi: Optional[FaultInjector] = fault_inject
        # load-shedding budget: float (every tier) or {tier: budget_s}
        if shed_budget_s is None:
            env = os.environ.get("REPRO_SHED_BUDGET_S", "").strip()
            shed_budget_s = float(env) if env else None
        self._shed_budget = shed_budget_s
        if watchdog_s is None:
            env = os.environ.get("REPRO_WATCHDOG_S", "").strip()
            watchdog_s = float(env) if env else 0.0
        self._watchdog_s = float(watchdog_s or 0.0)
        # service rate of the shed estimate: EWMA of emitted tokens per
        # decode-cycle second, 0.0 until the first tokens
        self._decode_rate = 0.0
        self._rate_alpha = 0.3

        B = max_batch
        self._scheduler = Scheduler(max_admit=max_admit,
                                    tier_targets=tier_targets)
        self._scheduler.on_event = self._sched_event
        # slot state: written by the SERIAL decode stage (merge/window/grow/
        # step) and the complete stage (free) under _state_lock
        self._lengths = np.zeros((B,), np.int32)   # KV tokens written
        self._rem = np.zeros((B,), np.int32)       # decode steps remaining
        self._last = np.zeros((B,), np.int32)      # last emitted token
        # seat generation per slot, bumped at every seat, retirement and
        # preemption: a synced chunk's tokens land only on the seat they
        # were computed for (async)
        self._slot_gen = np.zeros((B,), np.int64)
        self._pending: Optional[dict] = None         # chunk in flight
        self._window_pending: Optional[dict] = None  # window in flight
        # async: copies that do not wait for the chunk in flight, the two
        # pinned token buffers chunks alternate between, and (CUDA) the
        # prefill stage's own stream
        self._link = HostLink(self.device) if self.async_decode else None
        self._tok_host: List[Optional[torch.Tensor]] = [None, None]
        self._tok_i = 0
        self._pf_stream = torch.cuda.Stream(self.device) \
            if (self.async_decode and cuda) else None
        self._slot_req: List[Optional[ServeRequest]] = [None] * B
        self._slot_out: List[Optional[List[int]]] = [None] * B
        self._slot_phase: List[Optional[str]] = [None] * B  # prefill|decode
        self._free_slots = list(range(B - 1, -1, -1))
        self._slots_reserved = 0       # admitted but not yet merged
        self._inflight: set = set()    # admitted, not yet retired
        self._cycle_tokens: set = set()  # cycles minted, not yet completed
        # admitted groups not yet seated, by cycle token: (epoch, requests);
        # a failure-isolation reset clears it, so a group admitted against
        # the old pool is dropped at its merge
        self._premerge: Dict[int, tuple] = {}
        # bumped by every failure-isolation reset: retire payloads of an
        # older epoch free no blocks or slots into the reset state
        self._reset_epoch = 0
        self._state_lock = threading.Lock()
        self._pump_lock = threading.Lock()
        self._pipeline: Optional[DataPipeline] = None
        self.stats = {"admitted": 0, "admit_parks": 0, "pump_cycles": 0,
                      "decode_cycles": 0, "prefills": 0,
                      "prefill_windows": 0, "tokens_out": 0, "retired": 0,
                      "grown_blocks": 0, "preempted": 0, "stalls": 0,
                      "prefix_hits": 0, "prefix_tokens_saved": 0,
                      "cow_forks": 0, "shed": 0, "expired": 0,
                      "cancelled": 0, "watchdog_fires": 0,
                      "row_failures": 0}

        self._prefix: Optional[PrefixCache] = None
        if self.paged:
            self._init_paged(B, kv_blocks, block_size, max_seq_len,
                             prefill_chunk)
        else:
            self._init_slots(B, max_seq_len)
        with self._stage_ctx():
            self._chunk = ChunkProgram(self._chunk_step, self._chunk_statics,
                                       B, decode_chunk, self.device,
                                       graph=bool(chunk_graph))
        if self.async_decode:
            self._tok_host = [torch.zeros(tuple(self._chunk.out.shape),
                                          dtype=torch.int32, pin_memory=cuda)
                              for _ in range(2)]
        # observability: one open phase span per seated slot (name, t0);
        # None obs = disabled (every site guards on self._tr / self._mh)
        self._slot_span: List[Optional[tuple]] = [None] * B
        self.set_obs(obs if obs is not None else _obs_from_env())
        # watchdog heartbeat, touched by submit and the admit, decode and
        # complete stages
        self._wd_beat = time.perf_counter()
        self._wd_stop = threading.Event()
        self._wd_thread: Optional[threading.Thread] = None
        if self._watchdog_s > 0:
            self._wd_thread = threading.Thread(
                target=self._watchdog_loop, name="serve-watchdog",
                daemon=True)
            self._wd_thread.start()

    def _init_paged(self, B: int, kv_blocks: int, block_size: int,
                    max_seq_len: Optional[int],
                    prefill_chunk: Optional[int]) -> None:
        self._pool = BlockPool(kv_blocks, block_size)
        self._pkv = init_kv_pool(self.cfg, kv_blocks, block_size,
                                 self.device)
        if self.prefix_cache:
            self._prefix = PrefixCache(self._pool)
        self._max_seq = min(max_seq_len or 32 * block_size,
                            (kv_blocks - 1) * block_size)
        self.prefill_chunk = prefill_chunk or self.decode_chunk * block_size
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        mb = self._pool.blocks_for(self._max_seq)
        # block tables: host mirror for growth decisions + a DEVICE-resident
        # tensor the model reads; growth/merge/retire update it in place
        self._tables = np.zeros((B, mb), np.int32)
        self._tables_dev = torch.zeros((B, mb), dtype=torch.int32,
                                       device=self.device)
        self._pref_pos = np.zeros((B,), np.int32)  # prompt tokens done
        self._slot_blocks: List[Optional[List[int]]] = [None] * B
        self._slot_prompt: List[Optional[np.ndarray]] = [None] * B
        # chunked-prefill window buffers: invariant — a row's `valid`
        # entries are False unless it is mid-prefill
        C = self.prefill_chunk
        self._wp_toks = np.zeros((B, C), np.int32)
        self._wp_valid = np.zeros((B, C), bool)
        self._wp_start = np.zeros((B,), np.int32)
        self._wp_last_idx = np.zeros((B,), np.int32)
        # a row whose growth failed because every victim outranks it is
        # STALLED (rem masked to 0) with its remaining steps parked here
        self._stall_rem = np.zeros((B,), np.int32)

    def _init_slots(self, B: int, max_seq_len: Optional[int]) -> None:
        # fixed-slot recurrent-state pool: init_cache's dict with the scalar
        # pos replaced by the per-row _lengths mirror; written in place by
        # the SERIAL decode stage only (merge and the decode chunk)
        self._max_seq = max_seq_len or 512
        self.prefill_chunk = None
        self._pool = None
        self._sstate = {k: v for k, v in lm.init_cache(
            self.cfg, B, self._max_seq, self.device).items() if k != "pos"}

    # ------------------------------------------------------------- helpers
    def _to_dev(self, *arrays: np.ndarray):
        """Device copies of ``arrays`` (one tensor for one array). Sync: a
        blocking copy each. Async: pinned staging copies that never wait
        for the stream (:meth:`HostLink.upload`)."""
        if self._link is not None:
            out = self._link.upload(*arrays)
        else:
            out = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                   for a in arrays]
        return out[0] if len(out) == 1 else out

    def _clear_rows_dev(self, rows) -> None:
        """Zero vacated seats' device rows: their block-table rows (paged)
        and, async, their carry rows; one upload of the row ids. (``t[r] =
        0`` would copy the 0 to the device from pageable memory, a stream
        sync; ``index_fill_`` passes it to the kernel.)"""
        r = self._to_dev(np.asarray(rows, np.int32)).long()
        if self.paged:
            self._tables_dev.index_fill_(0, r, 0)
        if self.async_decode:
            self._chunk.carry.index_fill_(1, r, 0)

    def _chunk_step(self, carry):
        """The decode chunk's body for :class:`ChunkProgram` (the module
        attribute is looked up at each call, so tests can patch it)."""
        n = self.decode_chunk
        if self.paged:
            return lm.decode_chunk_paged(
                self.cfg, self.params, self._pkv, self._tables_dev, carry,
                n, impl=self.paged_impl, layers=self._layers)
        return lm.decode_chunk_slots(self.cfg, self.params, self._sstate,
                                     carry, n, layers=self._layers)

    def _chunk_statics(self):
        """Every tensor the captured chunk reads or writes besides its
        carry and output, from the engine's current attributes."""
        if self.paged:
            yield "pool", self._pkv
            yield "tables", self._tables_dev
        else:
            for name, v in self._sstate.items():
                for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                    yield f"state.{name}.{i}", t
        yield from (("params." + k, t) for k, t in _leaves(self.params))

    def _wait_for(self, ev) -> None:
        """Order the current stream after ``ev`` (the prefill stream's
        end), a no-op without one."""
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    @contextlib.contextmanager
    def _stage_ctx(self):
        """Per-stage thread context: inference mode and the engine's CUDA
        device are thread-local, and stages run on executor workers."""
        with torch.inference_mode():
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    yield
            else:
                yield

    def _log(self, stage: str, token: int, info: Any) -> None:
        if self._stage_log is not None:
            with self._log_lock:
                self._stage_log.append((stage, token, info,
                                        time.perf_counter()))

    @property
    def stage_log(self) -> List[tuple]:
        """(stage, cycle-token, info, timestamp) events (record_stages)."""
        with self._log_lock:
            return list(self._stage_log or [])

    # ---------------------------------------------------------- observability
    def set_obs(self, obs) -> None:
        """Attach (or detach, with None) a :class:`repro_torch.obs
        .Observability`: every metric handle is cached once here, the
        registry goes to the scheduler, the block pool and the prefix cache,
        and the tracer to the resident pipeline. Rebindable while the engine
        is idle (the overhead gate toggles it on one engine)."""
        self.obs = obs
        self._tr = obs.tracer if obs is not None else None
        metrics = obs.metrics if obs is not None else None
        self._scheduler.set_metrics(metrics)
        if self.paged:
            self._pool.set_metrics(metrics)
        if self._prefix is not None:
            self._prefix.set_metrics(metrics)
        if self._pipeline is not None:
            self._pipeline.tracer = self._tr
        #: per-tier TTFT histograms (serve.ttft_s.tier<N>), made lazily
        self._mh_tier: Dict[int, Any] = {}
        if metrics is None:
            self._mh = None
            return
        self._mh = {
            "tokens_out": metrics.counter("serve.tokens_out"),
            "admitted": metrics.counter("serve.requests.admitted"),
            "retired": metrics.counter("serve.requests.retired"),
            "preempted": metrics.counter("serve.requests.preempted"),
            "stalled": metrics.counter("serve.requests.stalled"),
            "grown_blocks": metrics.counter("pool.grown_blocks"),
            "prefill_saved": metrics.counter("serve.prefill_tokens_saved"),
            "resident": metrics.gauge("serve.resident_rows"),
            "ttft": metrics.histogram("serve.ttft_s"),
            "qwait": metrics.histogram("serve.queue_wait_s"),
            "cycle": metrics.histogram("engine.cycle_s"),
            "dispatch": metrics.histogram("engine.dispatch_s"),
            "sync": metrics.histogram("engine.chunk_sync_s"),
            "book": metrics.histogram("engine.book_s"),
            "gap": metrics.histogram("engine.gap_s"),
            "chunk": metrics.histogram("engine.chunk_s"),
            "shed": metrics.counter("serve.shed"),
            "expired": metrics.counter("serve.expired"),
            "cancelled": metrics.counter("serve.cancelled"),
            "watchdog": metrics.counter("serve.watchdog_fires"),
            "row_failed": metrics.counter("serve.row_failures"),
        }

    def _phase_begin(self, slot: int, name: str, t: float) -> None:
        self._slot_span[slot] = (name, t)

    def _phase_end(self, slot: int, t: float, req=None) -> None:
        cur = self._slot_span[slot]
        self._slot_span[slot] = None
        if cur is not None and self._tr is not None:
            args = {"req": req.id} if req is not None else None
            self._tr.add(cur[0], f"slot{slot}", cur[1], t, args)

    def _note_seated(self, slot: int, req, now: float) -> None:
        """Lifecycle spans emitted at seat time (the slot is unknown until
        the merge): ``queued`` [enqueue -> admission], ``admitted``
        [admission -> merge], then the open ``prefill``/``decode`` span. A
        preempted request re-enters here at its next admission."""
        tr = self._tr
        track = f"slot{slot}"
        adm = req.last_admitted_at or now
        if req.queued_since is not None:
            tr.add("queued", track, req.queued_since, adm,
                   {"req": req.id, "preempted": req.preempted_count})
        tr.add("admitted", track, adm, now, {"req": req.id})
        self._phase_begin(slot, self._slot_phase[slot], now)

    def _note_resident(self) -> None:
        if self._mh is not None:
            self._mh["resident"].set(
                sum(r is not None for r in self._slot_req))

    def _sched_event(self, kind: str, req) -> None:
        """The scheduler's sweep dropped a waiting request (outside its
        lock): ``kind`` is ``"expired"`` or ``"cancelled"``."""
        with self._state_lock:
            self.stats[kind] += 1
        if self._mh is not None:
            self._mh[kind].inc()
        if self._tr is not None:
            self._tr.instant(kind, TRACK_ENGINE, time.perf_counter(),
                             {"req": req.id, "state": "waiting"})

    # ------------------------------------------------------------- lifecycle
    def _ensure_executor(self) -> Executor:
        if self._executor is None:
            self._executor = Executor(domains={HOST: 2, ACCEL: 1})
        return self._executor

    def _ensure_pipeline(self) -> DataPipeline:
        if self._pipeline is None:
            self._pipeline = DataPipeline(
                PIPELINE_LINES,
                DataPipe(PipeType.SERIAL, self._st_admit, name="admit"),
                DataPipe(PipeType.SERIAL, self._st_prefill, name="prefill"),
                DataPipe(PipeType.SERIAL, self._st_decode, name="decode",
                         domain=ACCEL),
                DataPipe(PipeType.PARALLEL, self._st_complete,
                         name="complete"),
                name="serve-continuous")
            # pipe-body intervals become lineN spans when tracing is on
            self._pipeline.tracer = self._tr
        return self._pipeline

    def _busy(self) -> bool:
        """Lock-free busy probe (the watchdog must never wait on a lock a
        wedged stage may hold)."""
        return bool(self._inflight) or bool(self._cycle_tokens) \
            or self._scheduler.num_waiting > 0

    def _watchdog_loop(self) -> None:
        """Daemon thread: fail every outstanding future typed
        :class:`WatchdogTimeout` when a busy engine has not touched its
        heartbeat for ``watchdog_s``. The stuck call (a replay, a blocked
        read-back) is not interrupted; ``result()`` raises instead of
        hanging."""
        period = max(0.01, self._watchdog_s / 4.0)
        while not self._wd_stop.wait(period):
            if self._broken is not None:
                return
            stale = time.perf_counter() - self._wd_beat
            if stale <= self._watchdog_s or not self._busy():
                continue
            err = WatchdogTimeout(
                f"engine made no cycle progress for {stale:.3f}s "
                f"(budget {self._watchdog_s:.3f}s; "
                f"inflight={len(self._inflight)} "
                f"waiting={self._scheduler.num_waiting} "
                f"cycles={sorted(self._cycle_tokens)}; a stuck device "
                f"sync or a deadlocked stage - failing all futures)")
            self._broken = err
            with self._state_lock:
                self.stats["watchdog_fires"] += 1
            if self._mh is not None:
                self._mh["watchdog"].inc()
            if self._tr is not None:
                self._tr.instant("watchdog_fire", TRACK_ENGINE,
                                 time.perf_counter(), {"stale_s": stale})
            self._fail_outstanding(err)
            return

    def close(self, timeout: float = 300.0) -> None:
        """Drain outstanding requests, then release the executor. Anything
        still outstanding after the drain budget (or after a breakage)
        fails typed :class:`EngineClosed`. Idempotent."""
        self._closing = True
        if self._pipeline is not None:
            deadline = time.perf_counter() + timeout
            while time.perf_counter() < deadline:
                if self._broken is not None:
                    break
                if self._pipeline.idle() and self._scheduler.num_waiting == 0:
                    break
                time.sleep(0.005)
        self._wd_stop.set()
        if self._wd_thread is not None:
            self._wd_thread.join(timeout=1.0)
            self._wd_thread = None
        if self._busy():
            self._fail_outstanding(EngineClosed(
                "engine closed with requests outstanding "
                "(drain timeout or prior failure)"))
        if self.paged and self._pending is None:
            # drained: no chunk in flight, every deferred block is past the
            # device work that fenced it -- flush the fence
            while self._pool.num_deferred:
                self._pool.release_deferred()
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------- stage callables
    def _st_admit(self, pf):
        t_adm = time.perf_counter()
        self._wd_beat = t_adm
        epoch = self._reset_epoch
        with self._state_lock:
            occupied = any(r is not None for r in self._slot_req)
            reserved = self._slots_reserved
            deps = set(self._cycle_tokens)
            free_slots = len(self._free_slots) - reserved
        waiting = self._scheduler.num_waiting
        if not waiting and not occupied and reserved == 0:
            # fully idle: drain so the engine parks at zero cost; the next
            # submit() re-arms the SAME resident grid
            pf.stop()
            return None
        group = None
        if self.paged:
            group = self._admit_paged(free_slots)
        else:
            # slot-state pool: recurrent state is pre-allocated per slot, so
            # admission is bounded by free slots alone
            popped = self._scheduler.try_admit(free_slots, None,
                                               hopeless=self._hopeless_why)
            if popped is not None:
                group = [(r, None) for r in popped]
        if group is not None:
            now = time.perf_counter()
            for g in group:
                r = g[0]
                r.state = "prefilling"
                if r.admitted_at is None:
                    r.admitted_at = now
                    if self._mh is not None and r.submitted_at is not None:
                        self._mh["qwait"].record(now - r.submitted_at)
            with self._state_lock:
                stale = epoch != self._reset_epoch
                if not stale:
                    self._slots_reserved += len(group)
                    self._inflight.update(g[0] for g in group)
                    self._cycle_tokens.add(pf.token)
                    self._premerge[pf.token] = (epoch,
                                                [g[0] for g in group])
                    self.stats["admitted"] += len(group)
            if stale:
                # a failure-isolation reset raced this admission: its block
                # ids came from the old pool. Fail the group typed (a
                # re-submit replays it) instead of seating it on the new one
                err = RowFailed(
                    "admission raced an engine failure-isolation reset")
                for g in group:
                    g[0].set_error(err)
                return ("pump", None)
            if self._mh is not None:
                self._mh["admitted"].inc(len(group))
            if self._tr is not None:
                self._tr.add("admission", TRACK_ENGINE, t_adm, now,
                             {"reqs": [g[0].id for g in group]})
            self._log("admit", pf.token, [g[0].id for g in group])
            return ("admit", group)
        if waiting and deps:
            # the head does not fit: park THIS cycle until the oldest
            # in-flight cycle completes (its complete stage frees blocks)
            dep = min(deps)
            with self._state_lock:
                self.stats["admit_parks"] += 1
            self._log("park", pf.token, dep)
            pf.defer(dep)
            return None
        # nothing admittable but sequences are running: pure decode pump
        with self._state_lock:
            self._cycle_tokens.add(pf.token)
            self.stats["pump_cycles"] += 1
        if self._tr is not None:
            self._tr.add("admission", TRACK_ENGINE, t_adm,
                         time.perf_counter(), {"pump": True})
        self._log("pump", pf.token, None)
        return ("pump", None)

    def _admit_paged(self, free_slots: int) -> Optional[List[tuple]]:
        """Phase 1 of two-phase admission: budget the PROMPT footprint only;
        decode-time blocks are granted lazily by the decode stage. The
        budget excludes the stalled-row reservation floor. With the prefix
        cache, a prompt's cached full chunks leave its budget (the peek is
        conservative: registration can only grow a match before the pin)
        and parked cached blocks count as free, being evictable on demand.
        Returns ``(request, own block ids, PrefixHit or None)`` triples."""
        px = self._prefix
        if px is not None:
            bs = self._pool.block_size

            def need_for(r):
                return self._pool.blocks_for(r.prompt_len) \
                    - px.peek(r.prompt) // bs
            budget = self._pool.num_free_unreserved + px.num_parked
        else:
            def need_for(r):
                return self._pool.blocks_for(r.prompt_len)
            budget = self._pool.num_free_unreserved
        popped = self._scheduler.try_admit(free_slots, budget, need_for,
                                           hopeless=self._hopeless_why)
        if popped is None:
            return None
        # pin the longest cached prefix per member (a reference on every
        # matched block) and allocate only the uncached suffixes
        hits = [px.match_and_pin(r.prompt) if px is not None else None
                for r in popped]
        needs = [self._pool.blocks_for(r.prompt_len)
                 - (len(h.blocks) if h is not None else 0)
                 for r, h in zip(popped, hits)]
        if self._fi is not None and self._fi.fire("alloc_fail"):
            ids = None                          # injected failure
        else:
            ids = self._pool.alloc(sum(needs))  # all-or-nothing
        if ids is None and px is not None:
            # release cold PARKED prefix blocks before giving up on the
            # group, long before the grow pass would preempt a row
            short = sum(needs) - self._pool.num_free_unreserved
            if short > 0:
                px.evict(short)
            ids = self._pool.alloc(sum(needs))
        if ids is None:
            # raced a concurrent mid-decode grow: unpin, put the group back
            for h in hits:
                if h is None:
                    continue
                pins = list(h.blocks)
                if h.partial_block is not None:
                    pins.append(h.partial_block)
                if pins:
                    px.unpin(pins)
            self._scheduler.requeue_front(popped)
            return None
        group, i, saved, nhit = [], 0, 0, 0
        for r, h, need in zip(popped, hits, needs):
            group.append((r, ids[i:i + need], h))
            i += need
            if h is not None and h.tokens > 0:
                nhit += 1
                saved += h.tokens
        if nhit:
            with self._state_lock:
                self.stats["prefix_hits"] += nhit
                self.stats["prefix_tokens_saved"] += saved
            if self._mh is not None:
                self._mh["prefill_saved"].inc(saved)
        return group

    def _st_prefill(self, pf, msg):
        kind, payload = msg
        if kind != "admit":
            return msg
        with self._stage_ctx():
            try:
                if self._pf_stream is None:
                    return self._prefill_group(pf, payload)
                # async on CUDA: the prefill runs beside the chunk in
                # flight, on its own stream (it reads only the prompts and
                # the weights); the merge waits for it by event
                with torch.cuda.stream(self._pf_stream):
                    return self._prefill_group(pf, payload)
            except Exception as exc:        # per-group failure isolation
                return self._prefill_failed(pf, payload, exc)

    def _prefill_failed(self, pf, group, exc):
        """A raising prefill fails ONLY its admitted group (typed
        :class:`RowFailed`) and releases what the group holds; the prefill
        writes no shared device state, so nothing is reset (contrast
        :meth:`_isolate_failure`)."""
        err = RowFailed(f"prefill launch failed for group "
                        f"{[g[0].id for g in group]}: {exc!r}")
        err.__cause__ = exc
        with self._state_lock:
            info = self._premerge.pop(pf.token, None)
            live = info is not None and info[0] == self._reset_epoch
            if live:
                self._slots_reserved -= len(group)
                for g in group:
                    self._inflight.discard(g[0])
            self.stats["row_failures"] += len(group)
        if live and self.paged:
            for _, blocks, hit in group:
                if blocks:
                    # allocated at admission, never written: no device work
                    # reads them, a plain free is safe in async mode too
                    self._pool.free(list(blocks))
                if hit is not None:
                    pins = list(hit.blocks)
                    if hit.partial_block is not None:
                        pins.append(hit.partial_block)
                    if pins:
                        self._prefix.unpin(pins)
        for g in group:
            g[0].set_error(err)
        if self._mh is not None:
            self._mh["row_failed"].inc(len(group))
        if self._tr is not None:
            self._tr.instant("prefill_failed", TRACK_ENGINE,
                             time.perf_counter(),
                             {"reqs": [g[0].id for g in group]})
        self._log("prefill_failed", pf.token, [g[0].id for g in group])
        return ("pump", None)

    def _read_first(self, first: torch.Tensor):
        """The host copy of a prefill's first tokens: now (sync), or
        enqueued behind an event on the current stream (async), which also
        marks the end of the prefill's device work."""
        if self._link is None:
            return first.cpu(), None
        return self._link.read(first)

    def _prefill_group(self, pf, group):
        """Paged: one launch for the group's FIRST prompt window: prompts
        are right-padded to one window shape, a power of two capped at
        ``prefill_chunk`` (pad rows repeat the last request and scatter to
        the sink). Remaining windows stream through the decode stage.
        Prefix-cache HIT rows take no row of this launch: the group is
        reordered misses first, so launch row i is group member i for every
        window-0 member, and a group of hits launches nothing.
        Slot-state: one whole-prompt prefill per member at B=1 (the state
        is O(1) per sequence; there is no per-token KV to window)."""
        reqs = [g[0] for g in group]
        if not self.paged:
            caches, firsts = [], []
            for req in reqs:
                if req._ssm_ckpt is not None:
                    # checkpoint-preempted row: its exact state was saved
                    # at the preemption and is re-seated by the merge
                    caches.append(None)
                    continue
                logits, cache = lm.prefill(
                    self.cfg, self.params, self._to_dev(req.prompt[None]),
                    layers=self._layers)
                caches.append(cache)
                firsts.append(torch.argmax(logits[0]).to(torch.int32))
            first = self._read_first(torch.stack(firsts)) if firsts \
                else (None, None)
            with self._state_lock:
                self.stats["prefills"] += len(firsts)
            self._log("prefill", pf.token, [r.id for r in reqs])
            return ("admit", (reqs, caches, first))
        miss = [g for g in group if g[2] is None or g[2].tokens == 0]
        hitg = [g for g in group if not (g[2] is None or g[2].tokens == 0)]
        group = miss + hitg
        if not miss:
            self._log("prefill", pf.token, [r.id for r in reqs])
            return ("admit", (group, 0, None, None, None, 0))
        longest = max(g[0].prompt_len for g in miss)
        C0 = min(self.prefill_chunk, 1 << max(0, longest - 1).bit_length())
        A = self._scheduler.max_admit
        toks = np.zeros((A, C0), np.int32)
        lastp = np.zeros((A,), np.int32)
        for i, g in enumerate(miss):
            r = g[0]
            k = min(r.prompt_len, C0)
            toks[i, :k] = r.prompt[:k]
            lastp[i] = k - 1
        for i in range(len(miss), A):
            toks[i] = toks[len(miss) - 1]
            lastp[i] = lastp[len(miss) - 1]
        toks, lastp = self._to_dev(toks, lastp)
        logits, cache = lm.prefill(self.cfg, self.params, toks, max_len=C0,
                                   last_positions=lastp,
                                   layers=self._layers)
        first = self._read_first(torch.argmax(logits, dim=-1)
                                 .to(torch.int32))
        with self._state_lock:
            self.stats["prefills"] += 1
        self._log("prefill", pf.token, [r.id for r in reqs])
        return ("admit", (group, C0, cache["k"], cache["v"], first,
                          len(miss)))

    # ------------------------------------------------- decode-stage helpers
    def _merge_group(self, pf, payload) -> None:
        """Seat an admitted group: assign slots, install block tables, and
        scatter the window-0 KV into the pool. Rows whose whole prompt fits
        window 0 enter decode immediately; longer ones enter the prefill
        phase and stream their remaining windows in later cycles.

        Prefix-cache HIT rows (members past ``n_miss``) seat their table
        with the pinned SHARED prefix blocks followed by their own suffix
        blocks and enter the prefill phase at the first uncached token; a
        partially matched tail block is forked copy-on-write here (a device
        copy into the row's first own block, which the table already points
        at), so the row's writes never touch the shared original. The copy
        is issued on the decode stage's stream before any window reads the
        block.

        Async: the seated rows' carry rows are written on the device (they
        were inactive in the chunk in flight, so writing over its output
        carry is exact), and the group's first tokens and KV are read after
        the prefill stream's event."""
        group, C0, ck, cv, first, n_miss = payload
        if not self._premerge_live(pf):
            return
        if first is not None:
            host, ev = first
            first = HostLink.wait(host, ev)
            self._wait_for(ev)
            if ev is not None:
                cur = torch.cuda.current_stream(self.device)
                ck.record_stream(cur)
                cv.record_stream(cur)
        nb0 = self._pool.blocks_for(C0) if C0 else 0
        now = time.perf_counter()
        rows_idx, rows_tab = [], []
        fork_src, fork_dst = [], []
        reg_slots = []
        for i, (req, blocks, hit) in enumerate(group):
            is_hit = hit is not None and i >= n_miss
            tab = (list(hit.blocks) if is_hit else []) + list(blocks)
            with self._state_lock:
                slot = self._free_slots.pop()
                self._slots_reserved -= 1
                self._slot_req[slot] = req
                self._slot_blocks[slot] = tab
                self._slot_out[slot] = []
            self._slot_gen[slot] += 1
            self._slot_prompt[slot] = req.prompt
            self._wp_valid[slot] = False
            self._stall_rem[slot] = 0
            self._tables[slot] = 0
            self._tables[slot, :len(tab)] = tab
            if is_hit:
                # the cached tokens are already in the pool: the window walk
                # starts at the first uncached token
                self._pref_pos[slot] = hit.tokens
                if hit.partial_block is not None:
                    # fork the partially matched tail block into the row's
                    # first own block (table column len(hit.blocks)): its
                    # cached leading tokens come along, the row's own writes
                    # land past them
                    fork_src.append(hit.partial_block)
                    fork_dst.append(blocks[0])
                    with self._state_lock:
                        self.stats["cow_forks"] += 1
                    if self._tr is not None:
                        self._tr.instant(
                            "cow_fork", f"slot{slot}", now,
                            {"req": req.id, "src": int(hit.partial_block),
                             "dst": int(blocks[0])})
            else:
                self._pref_pos[slot] = min(req.prompt_len, C0)
            self._lengths[slot] = self._pref_pos[slot]
            if i < n_miss and req.prompt_len <= C0:
                self._slot_phase[slot] = "decode"
                self._last[slot] = first[i]
                self._rem[slot] = req.max_new - 1
                self._slot_out[slot].append(int(first[i]))
                req.state = "decoding"
                self._note_first_token(req, now)
                reg_slots.append(slot)
            else:
                self._slot_phase[slot] = "prefill"
                self._last[slot] = 0
                self._rem[slot] = 0   # masked out of decode until prefilled
            if self._tr is not None:
                self._note_seated(slot, req, now)
            rows_idx.append(slot)
            rows_tab.append(self._tables[slot].copy())
        set_table_rows(self._tables_dev,
                       *self._to_dev(np.asarray(rows_idx, np.int32),
                                     np.stack(rows_tab)))
        if self.async_decode:
            self._scatter_carry(rows_idx)
        if fork_src:
            # one copy for the group's forks, unpadded: its destinations are
            # distinct fresh blocks (duplicate destinations of an indexed
            # copy would be written in no set order on CUDA)
            copy_blocks(self._pkv,
                        *self._to_dev(np.asarray(fork_src, np.int32),
                                      np.asarray(fork_dst, np.int32)))
            self._prefix.unpin(fork_src)   # fork done: drop the tail pins
        if n_miss:
            # window-0 scatter: per-row block lists trimmed/padded to the
            # window footprint (sink beyond a short prompt's own blocks and
            # for the group's pad rows)
            blocks2d = np.zeros((ck.shape[1], nb0), np.int32)
            for i, (_, blocks, _) in enumerate(group[:n_miss]):
                row = blocks[:nb0]
                blocks2d[i, :len(row)] = row
            scatter_prefill_rows(self._pkv, self._to_dev(blocks2d), ck, cv)
        for slot in reg_slots:
            self._register_prefix(slot)
        with self._state_lock:
            self._premerge.pop(pf.token, None)   # fully seated
        self._note_resident()

    def _premerge_live(self, pf) -> bool:
        """Epoch guard at a merge: a group admitted before a failure-
        isolation reset must not seat (its block ids came from the old
        pool, and the reset failed its requests). Peeks; the record is
        popped at the END of the merge, so a failure mid-merge still finds
        every member in the table and fails it."""
        with self._state_lock:
            info = self._premerge.get(pf.token)
            return info is not None and info[0] == self._reset_epoch

    def _register_prefix(self, slot: int) -> None:
        """Index a just-prefilled row's FULL prompt chunks in the prefix
        trie (decode entry is the registration point: every full prompt
        block is final, decode writes land strictly past the prompt)."""
        if self._prefix is None:
            return
        prompt = self._slot_prompt[slot]
        blocks = self._slot_blocks[slot]
        if prompt is not None and blocks is not None:
            self._prefix.register(prompt, blocks)

    def _merge_group_slots(self, pf, payload) -> None:
        """Seat an admitted slot-state group: copy each member's prefilled
        state into its slot of the state pool and start it decoding from
        its first token. The copies are enqueued on the decode stage's
        stream after the chunk in flight, whose in-place update of an
        inactive slot they overwrite; async writes the carry rows too. A
        checkpoint-preempted member (synchronous engine) gets its saved
        state back and resumes where it stopped, with no prefill."""
        reqs, caches, (host, ev) = payload
        if not self._premerge_live(pf):
            return
        firsts = iter(HostLink.wait(host, ev).tolist() if host is not None
                      else ())
        self._wait_for(ev)
        now = time.perf_counter()
        rows = []
        for req, cache in zip(reqs, caches):
            ckpt = req._ssm_ckpt
            with self._state_lock:
                slot = self._free_slots.pop()
                self._slots_reserved -= 1
                self._slot_req[slot] = req
                self._slot_phase[slot] = "decode"
            self._slot_gen[slot] += 1
            if ckpt is not None:
                state, length, last, rem, out = ckpt
                req._ssm_ckpt = None
                self._restore_slot_state(slot, state)
                self._slot_out[slot] = list(out)
                self._lengths[slot] = length
                self._last[slot] = last
                self._rem[slot] = rem
            else:
                first = next(firsts)
                if ev is not None:
                    cur = torch.cuda.current_stream(self.device)
                    for t in _tensors(cache):
                        t.record_stream(cur)
                write_slot_state(self._sstate, slot, cache, req.prompt_len)
                self._slot_out[slot] = [first]
                self._lengths[slot] = req.prompt_len
                self._last[slot] = first
                self._rem[slot] = req.max_new - 1
                self._note_first_token(req, now)
            req.state = "decoding"
            if self._tr is not None:
                self._note_seated(slot, req, now)
            rows.append(slot)
        if self.async_decode:
            self._scatter_carry(rows)
        with self._state_lock:
            self._premerge.pop(pf.token, None)   # fully seated
        self._note_resident()

    def _slot_views(self, slot: int):
        """(name, view of ``slot``) for every leaf of the slot-state pool:
        Mamba1's ``ssm`` (conv, h) and zamba2's ``g_ssm``, ``tail_ssm`` and
        whole ``shared_k``/``shared_v`` spans."""
        for name, v in self._sstate.items():
            # the slot axis: after (G, every) for g_ssm, after the layer
            # (or group) axis for the rest
            ax = 2 if name == "g_ssm" else 1
            for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                yield f"{name}.{i}", t.select(ax, slot)

    def _save_slot_state(self, slot: int) -> Dict[str, torch.Tensor]:
        """One slot's recurrent state (and zamba2's shared KV span) copied
        to host memory: the checkpoint of an SSM or hybrid preemption.
        Synchronous engine only (async's chunk in flight has advanced the
        state past the host mirrors; its rows replay from the prompt)."""
        return {name: t.to("cpu", copy=True)
                for name, t in self._slot_views(slot)}

    def _restore_slot_state(self, slot: int, st) -> None:
        """Copy a :meth:`_save_slot_state` checkpoint into ``slot`` (any
        free slot), in place."""
        for name, t in self._slot_views(slot):
            t.copy_(st[name])

    def _scatter_carry(self, rows) -> None:
        """Write the host mirrors' ``rows`` into the device carry in place
        (async only: the sync path copies every mirror into the carry
        before each chunk). One upload of the row ids and values; torch
        pins no compiled shape, so no padding."""
        rows = np.asarray(rows, np.int32)
        vals = np.stack([self._lengths[rows], self._last[rows],
                         self._rem[rows]]).astype(np.int32)
        dev = self._to_dev(np.concatenate([rows[None], vals]))
        c = self._chunk.carry
        set_carry_rows(c[0], c[1], c[2], dev[0], dev[1], dev[2], dev[3])

    def _note_first_token(self, req, now: float) -> None:
        if req.first_token_at is None:
            req.first_token_at = now
            if self._mh is not None and req.submitted_at is not None:
                ttft = now - req.submitted_at
                self._mh["ttft"].record(ttft)
                h = self._mh_tier.get(req.priority)
                if h is None:
                    h = self.obs.metrics.histogram(
                        f"serve.ttft_s.tier{req.priority}")
                    self._mh_tier[req.priority] = h
                h.record(ttft)

    def _window_prefill_step(self, pf) -> None:
        """Synchronous chunked prefill: build, launch and complete ONE
        prefill window for every mid-prefill row in the same cycle. The
        async path calls :meth:`_dispatch_window_prefill` itself and
        completes the window a cycle later."""
        pend = self._dispatch_window_prefill(pf)
        if pend is not None:
            self._finish_window(pend)

    def _dispatch_window_prefill(self, pf) -> Optional[dict]:
        """Launch ONE prefill window for every mid-prefill row: the window's
        KV is computed against the row's paged prefix and scattered straight
        into the pool. Only prefilling rows are written into the window
        buffers; everyone else's ``valid`` entries are invariantly False.
        Returns the pending-window descriptor (None if no row prefills)."""
        B = len(self._slot_req)
        pref = [b for b in range(B) if self._slot_phase[b] == "prefill"]
        if not pref:
            return None
        C = self.prefill_chunk
        toks, valid = self._wp_toks, self._wp_valid
        start, last_idx = self._wp_start, self._wp_last_idx
        ks = {}
        for b in pref:
            prompt = self._slot_prompt[b]
            s = int(self._pref_pos[b])
            k = min(C, len(prompt) - s)
            toks[b, :k] = prompt[s:s + k]
            valid[b, :k] = True
            valid[b, k:] = False
            start[b] = s
            last_idx[b] = min(len(prompt) - 1 - s, C - 1)
            ks[b] = k
        first, _ = lm.prefill_window_paged(
            self.cfg, self.params, self._pkv, self._tables_dev,
            *self._to_dev(toks, start, valid, last_idx), layers=self._layers)
        with self._state_lock:
            self.stats["prefill_windows"] += 1
        return {"first": self._read_first(first), "rows": pref, "k": ks,
                "token": pf.token,
                "gen": {b: int(self._slot_gen[b]) for b in pref},
                "t_disp": time.perf_counter()}

    def _finish_window(self, pend: dict) -> None:
        """Complete a dispatched prefill window: advance per-row prompt
        positions and flip rows whose prompt just finished into decode,
        seeded by their first token. Async runs this a cycle after the
        launch (its event has passed by then: the launch preceded the
        chunk just synced), skips rows whose seat changed since, and writes
        the flipped rows' carry."""
        first = HostLink.wait(*pend["first"])
        now = time.perf_counter()
        flipped, done = [], []
        for b in pend["rows"]:
            if self._slot_gen[b] != pend["gen"][b] \
                    or self._slot_phase[b] != "prefill":
                continue                    # preempted since the launch
            done.append(b)
            prompt = self._slot_prompt[b]
            self._pref_pos[b] += pend["k"][b]
            self._lengths[b] = self._pref_pos[b]
            if self._tr is not None:
                self._tr.add("prefill_window", f"slot{b}", pend["t_disp"],
                             now, {"req": self._slot_req[b].id,
                                   "pos": int(self._pref_pos[b])})
            if self._pref_pos[b] >= len(prompt):
                req = self._slot_req[b]
                self._slot_phase[b] = "decode"
                self._last[b] = first[b]
                self._rem[b] = req.max_new - 1
                self._slot_out[b].append(int(first[b]))
                req.state = "decoding"
                self._note_first_token(req, now)
                if self._tr is not None:
                    self._phase_end(b, now, req)     # close "prefill"
                    self._phase_begin(b, "decode", now)
                self._wp_valid[b] = False
                self._register_prefix(b)
                flipped.append(b)
        if self.async_decode and flipped:
            self._scatter_carry(flipped)
        self._log("prefill_chunk", pend["token"],
                  [(b, int(self._pref_pos[b])) for b in done])

    def _victim_score(self, v: int):
        """Cost-model preemption order (ascending = preempt FIRST):
        ``(tier, work lost net of blocks reclaimed, prior preemptions,
        age)`` — best-effort tiers first, then the row losing the least
        generated work per block reclaimed; work-lost outranks the
        preemption count so two contending rows cannot self-evict forever
        (see the reference engine for the livelock this avoids)."""
        req = self._slot_req[v]
        out = self._slot_out[v]
        produced = len(out) if out is not None else 0
        blocks = self._slot_blocks[v] if self.paged else None
        held = len(blocks) if blocks is not None else 0
        return (-req.priority, produced - held, req.preempted_count,
                -req.id)

    def _fault_preempt(self, pf) -> None:
        """The ``preempt`` fault site: force-preempt the cost-model
        victim."""
        if self._fi is not None and self._fi.fire("preempt"):
            live = [v for v in range(len(self._slot_req))
                    if self._slot_req[v] is not None]
            if live:
                self._preempt(min(live, key=self._victim_score), pf)

    def _grow_or_preempt(self, pf) -> None:
        """Phase 2 of two-phase admission: grant each decoding row the
        blocks the NEXT decode chunk will write into, oldest row first.
        Pool exhaustion preempts the best COST-MODEL victim
        (:meth:`_victim_score`) back onto the wait queue; its blocks free
        immediately and it re-runs from scratch later (greedy decode is
        deterministic, so its tokens are unchanged). A row never preempts a
        victim of a strictly better tier: it stalls instead, and its unmet
        demand is reserved in the pool so admissions cannot take it."""
        bs = self._pool.block_size
        n = self.decode_chunk
        fi = self._fi
        if fi is not None:
            if fi.fire("evict") and self._prefix is not None:
                self._prefix.evict(1)      # forced parked-prefix eviction
            self._fault_preempt(pf)
        grow_rows: List[int] = []
        grow_cols: List[int] = []
        grow_ids: List[int] = []
        stall_rows: List[int] = []
        order = sorted((b for b in range(len(self._slot_req))
                        if self._slot_phase[b] == "decode"
                        and (self._rem[b] > 0 or self._stall_rem[b] > 0)),
                       key=lambda b: self._slot_req[b].id)
        victims = sorted((v for v in range(len(self._slot_req))
                          if self._slot_req[v] is not None),
                         key=self._victim_score)
        vi = 0
        for b in order:
            if self._slot_req[b] is None:
                continue                    # preempted as a victim already
            rem_b = int(self._rem[b]) + int(self._stall_rem[b])
            k = int(min(n, rem_b))
            need = (int(self._lengths[b]) + k - 1) // bs + 1
            cur = len(self._slot_blocks[b])
            covered = need <= cur
            while need > cur:
                if fi is not None and fi.fire("grow_fail"):
                    ids = None              # injected growth failure
                else:
                    ids = self._pool.grow_table(self._slot_blocks[b],
                                                need - cur,
                                                use_reserved=True)
                if ids is not None:
                    self._tables[b, cur:need] = ids
                    grow_rows.extend([b] * len(ids))
                    grow_cols.extend(range(cur, need))
                    grow_ids.extend(ids)
                    with self._state_lock:
                        self.stats["grown_blocks"] += len(ids)
                    if self._mh is not None:
                        self._mh["grown_blocks"].inc(len(ids))
                    covered = True
                    break
                if self._prefix is not None \
                        and self._prefix.evict(need - cur) > 0:
                    continue    # cold parked prefix blocks released: retry
                    # growth before stalling or preempting any row
                if self.async_decode and self._pool.num_deferred > 0:
                    break       # blocks in transit behind the fence: stall
                while vi < len(victims) \
                        and self._slot_req[victims[vi]] is None:
                    vi += 1
                if vi == len(victims):
                    break                   # nothing left to preempt
                victim = victims[vi]
                if self._slot_req[victim].priority \
                        < self._slot_req[b].priority:
                    break                   # stall rather than evict an SLO row
                vi += 1
                self._preempt(victim, pf)
                if victim == b:
                    break                   # b itself was the best victim
            if self._slot_req[b] is None:
                continue                    # b preempted itself
            if covered:
                if self._stall_rem[b]:      # blocks found: resume the row
                    self._rem[b] += self._stall_rem[b]
                    self._stall_rem[b] = 0
                    stall_rows.append(b)
                    if self._tr is not None:
                        _t = time.perf_counter()
                        self._phase_end(b, _t, self._slot_req[b])  # stalled
                        self._phase_begin(b, "decode", _t)
                    self._log("resume", pf.token, b)
            elif self._rem[b] > 0:
                # newly stalled: mask the row out of the next chunk
                self._stall_rem[b] = int(self._rem[b])
                self._rem[b] = 0
                stall_rows.append(b)
                with self._state_lock:
                    self.stats["stalls"] += 1
                if self._mh is not None:
                    self._mh["stalled"].inc()
                if self._tr is not None:
                    _t = time.perf_counter()
                    self._phase_end(b, _t, self._slot_req[b])  # close decode
                    self._phase_begin(b, "stalled", _t)
                self._log("stall", pf.token, b)
        unmet = 0
        for b in range(len(self._slot_req)):
            if self._stall_rem[b] > 0 and self._slot_req[b] is not None:
                k = int(min(n, self._stall_rem[b]))
                need = (int(self._lengths[b]) + k - 1) // bs + 1
                unmet += max(0, need - len(self._slot_blocks[b]))
        self._pool.set_reserved(unmet)
        if stall_rows and self.async_decode:
            # rem-only carry write (``last`` is on the device only)
            dev = self._to_dev(np.stack([
                np.asarray(stall_rows, np.int32),
                self._rem[stall_rows].astype(np.int32)]))
            self._chunk.carry[2][dev[0].long()] = dev[1]
        if grow_rows:
            self._log("grow", pf.token, list(zip(grow_rows, grow_ids)))
            extend_block_tables(
                self._tables_dev,
                *self._to_dev(np.asarray(grow_rows, np.int32),
                              np.asarray(grow_cols, np.int32),
                              np.asarray(grow_ids, np.int32)))

    def _cow_guard(self, pf) -> None:
        """Copy-on-write safety net, run before the window-prefill and
        decode-chunk launches of every cycle: a row about to WRITE into a
        block that is still shared (refcount > 1) forks it first (device
        copy, table repoint on the host mirror and the device, one
        reference dropped on the original). The engine's own flows never
        trip it (admission forks partial tail blocks at the merge, and full
        shared prompt blocks are never written again), but a write into a
        shared block would corrupt its co-holders silently, so the
        invariant is enforced here."""
        if self._prefix is None:
            return
        bs = self._pool.block_size
        srcs, dsts, rows, cols = [], [], [], []
        for b in range(len(self._slot_req)):
            if self._slot_req[b] is None or self._slot_blocks[b] is None:
                continue
            if self._slot_phase[b] == "decode":
                lo = int(self._lengths[b])
                k = int(min(self.decode_chunk,
                            int(self._rem[b]) + int(self._stall_rem[b])))
            elif self._slot_phase[b] == "prefill":
                lo = int(self._pref_pos[b])
                k = int(min(self.prefill_chunk,
                            len(self._slot_prompt[b]) - lo))
            else:
                continue
            if k <= 0:
                continue
            blocks = self._slot_blocks[b]
            hi = min((lo + k - 1) // bs + 1, len(blocks))
            for col in range(lo // bs, hi):
                old = blocks[col]
                if self._pool.refcount(old) <= 1:
                    continue
                ids = self._pool.alloc(1)
                if ids is None:
                    self._prefix.evict(1)
                    ids = self._pool.alloc(1)
                if ids is None:
                    # cannot fork and must not write the shared block:
                    # requeue the row, it replays later (deterministic)
                    self._preempt(b, pf)
                    break
                new = ids[0]
                blocks[col] = new
                self._tables[b, col] = new
                srcs.append(old)
                dsts.append(new)
                rows.append(b)
                cols.append(col)
                # drop OUR reference on the original (its co-holders keep
                # it alive, so nothing is released here; async passes it
                # through the fence like any block a chunk may still read)
                if self.async_decode:
                    self._pool.free_deferred([old])
                else:
                    self._pool.free([old])
                with self._state_lock:
                    self.stats["cow_forks"] += 1
                if self._tr is not None:
                    self._tr.instant("cow_fork", f"slot{b}",
                                     time.perf_counter(),
                                     {"req": self._slot_req[b].id,
                                      "src": int(old), "dst": int(new)})
        # a row preempted mid-pass zeroed its table and freed its blocks:
        # drop its queued forks
        live = [j for j in range(len(rows))
                if self._slot_req[rows[j]] is not None]
        if srcs and live:
            srcs = [srcs[j] for j in live]
            dsts = [dsts[j] for j in live]
            src_d, dst_d, row_d, col_d = self._to_dev(
                np.asarray(srcs, np.int32), np.asarray(dsts, np.int32),
                np.asarray([rows[j] for j in live], np.int32),
                np.asarray([cols[j] for j in live], np.int32))
            copy_blocks(self._pkv, src_d, dst_d)
            extend_block_tables(self._tables_dev, row_d, col_d, dst_d)

    def _vacate(self, slot: int, stat: str):
        """Detach the request seated in ``slot`` and reclaim the seat: its
        blocks (through the deferred-free fence in async mode: the chunk in
        flight and a window launched this cycle may still write them), its
        slot, its mirrors and its device rows; the seat generation bumps,
        so tokens of the chunk in flight for it are surplus. Counts one
        ``stat``; returns the request."""
        req = self._slot_req[slot]
        with self._state_lock:
            self._slot_req[slot] = None
            self._slot_out[slot] = None
            self._slot_phase[slot] = None
            if self.paged:
                if self.async_decode:
                    self._pool.free_deferred(self._slot_blocks[slot])
                else:
                    self._pool.free(self._slot_blocks[slot])
                self._slot_blocks[slot] = None
            self._free_slots.append(slot)
            self._inflight.discard(req)
            self.stats[stat] += 1
        self._slot_gen[slot] += 1
        self._lengths[slot] = 0
        self._last[slot] = 0
        self._rem[slot] = 0
        if self.paged:
            self._slot_prompt[slot] = None
            self._wp_valid[slot] = False
            self._tables[slot] = 0
            self._stall_rem[slot] = 0
            self._pref_pos[slot] = 0
        if self.paged or self.async_decode:
            self._clear_rows_dev([slot])
        return req

    def _preempt(self, slot: int, pf) -> None:
        """Requeue the seated request at the head of its tier; it replays
        from its prompt (greedy decode is deterministic). A synchronous
        slot-state row is CHECKPOINTED instead: its state is copied to host
        memory with its progress and re-seated exactly at its next
        admission, with no prefill."""
        req = self._slot_req[slot]
        if not self.paged and not self.async_decode \
                and self._slot_phase[slot] == "decode":
            req._ssm_ckpt = (self._save_slot_state(slot),
                             int(self._lengths[slot]),
                             int(self._last[slot]), int(self._rem[slot]),
                             list(self._slot_out[slot] or []))
        self._vacate(slot, "preempted")
        req.preempted_count += 1
        if self._mh is not None:
            self._mh["preempted"].inc()
            self._note_resident()
        if self._tr is not None:
            _t = time.perf_counter()
            self._phase_end(slot, _t, req)
            self._tr.instant("preempted", f"slot{slot}", _t, {"req": req.id})
        self._scheduler.requeue_front([req])
        self._log("preempt", pf.token, req.id)

    def _evict_row(self, slot: int, pf, err: BaseException,
                   kind: str) -> None:
        """Cancel or expire a SEATED row: reclaim its seat as a preemption
        does, but fail the request typed instead of requeueing it.
        ``kind`` is the stats and counter key (``"cancelled"`` or
        ``"expired"``)."""
        req = self._vacate(slot, kind)
        req.set_error(err)
        if self._mh is not None:
            self._mh[kind].inc()
            self._note_resident()
        if self._tr is not None:
            _t = time.perf_counter()
            self._phase_end(slot, _t, req)
            self._tr.instant(kind, f"slot{slot}", _t, {"req": req.id})
        self._log(kind, pf.token, req.id)

    def _sweep_seated(self, pf) -> None:
        """The per-cycle SLO sweep, in the decode stage before any launch
        (so its device writes precede them): seated rows with a cancel
        request or an elapsed deadline are evicted; the waiting queue's
        are dropped (:meth:`Scheduler.expire_waiting`); and when every slot
        is taken, a waiting head of a strictly better tier than the
        cost-model victim preempts it (one a cycle), so an SLO request does
        not wait out a best-effort row's whole decode."""
        now = time.perf_counter()
        for b in range(len(self._slot_req)):
            req = self._slot_req[b]
            if req is None:
                continue
            if req._cancel_requested:
                self._evict_row(b, pf, RequestCancelled(
                    f"request {req.id} cancelled while {req.state}"),
                    "cancelled")
            elif req.expired(now):
                self._evict_row(b, pf, DeadlineExceeded(
                    f"request {req.id} deadline ({req.deadline_s:.3f}s) "
                    f"expired while {req.state} "
                    f"({now - (req.submitted_at or now):.3f}s after "
                    f"submit)"), "expired")
        self._scheduler.expire_waiting(now)
        head = self._scheduler.peek_head()
        if head is None:
            return
        with self._state_lock:
            full = len(self._free_slots) <= self._slots_reserved
        if not full:
            return
        live = [v for v in range(len(self._slot_req))
                if self._slot_req[v] is not None]
        if not live:
            return
        victim = min(live, key=self._victim_score)
        if self._slot_req[victim].priority > head.priority:
            self._preempt(victim, pf)

    def _isolate_failure(self, pf, exc: BaseException):
        """Per-row failure isolation: a raising decode stage fails the rows
        it could have corrupted, every SEATED row and every admitted group
        not yet merged, typed :class:`RowFailed` (``__cause__`` is the
        exception), resets the device state in place and keeps serving;
        the waiting queue is untouched and replays later.

        The reset keeps every tensor the captured chunk reads at its
        address: after a device synchronize (the chunk in flight, and
        window and window-0 prefills on the prefill stream, have finished
        writing) the pool or slot state, the device tables and the carry
        are zeroed in place; the host ``BlockPool`` and ``PrefixCache`` are
        new. The reset epoch bumps under the state lock, so retire payloads
        and admitted groups of the old epoch free and seat nothing. A
        sticky CUDA error makes the synchronize raise: the engine then goes
        broken (every future fails), it never hangs."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        err = RowFailed(
            f"model step failed ({exc!r}); this row's seat was torn down "
            f"and the engine kept serving")
        err.__cause__ = exc
        B = len(self._slot_gen)
        now = time.perf_counter()
        with self._state_lock:
            self._reset_epoch += 1
            seated = [(b, r) for b, r in enumerate(self._slot_req)
                      if r is not None]
            pre = [r for _, reqs in self._premerge.values() for r in reqs]
            self._premerge.clear()
            victims = {r.id: r for _, r in seated}
            victims.update((r.id, r) for r in pre)
            for r in victims.values():
                self._inflight.discard(r)
            self._slot_req = [None] * B
            self._slot_out = [None] * B
            self._slot_phase = [None] * B
            self._free_slots = list(range(B - 1, -1, -1))
            self._slots_reserved = 0
            if self.paged:
                self._pool = BlockPool(self._pool.num_blocks,
                                       self._pool.block_size)
                self._slot_blocks = [None] * B
            self.stats["row_failures"] += len(victims)
        # host mirrors and device tensors: the decode stage's own
        self._slot_gen += 1            # every in-flight token is surplus
        self._lengths[:] = 0
        self._last[:] = 0
        self._rem[:] = 0
        self._pending = None
        self._window_pending = None
        if self.paged:
            self._pkv.zero_()
            self._tables_dev.zero_()
            self._stall_rem[:] = 0
            self._pref_pos[:] = 0
            self._wp_valid[:] = False
            self._tables[:] = 0
            self._slot_prompt = [None] * B
            metrics = self.obs.metrics if self.obs is not None else None
            self._pool.set_metrics(metrics)
            if self.prefix_cache:
                self._prefix = PrefixCache(self._pool)
                self._prefix.set_metrics(metrics)
        else:
            for t in _tensors(self._sstate):
                t.zero_()
        self._chunk.carry.zero_()
        for b, r in seated:
            if self._tr is not None:
                self._phase_end(b, now, r)
        for r in victims.values():
            r.set_error(err)
        if self._mh is not None and victims:
            self._mh["row_failed"].inc(len(victims))
            self._note_resident()
        if self._tr is not None:
            self._tr.instant("row_failure_reset", TRACK_ENGINE, now,
                             {"failed": sorted(victims),
                              "epoch": self._reset_epoch,
                              "cause": repr(exc)})
        self._log("row_failure", pf.token,
                  {"failed": sorted(victims), "cause": repr(exc)})
        return ("cycle", (self._reset_epoch, []))

    def _st_decode(self, pf, msg):
        self._wd_beat = time.perf_counter()
        with self._stage_ctx():
            try:
                if self.async_decode:
                    out = self._st_decode_async(pf, msg)
                else:
                    out = self._st_decode_sync(pf, msg)
            except Exception as exc:       # per-row failure isolation
                out = self._isolate_failure(pf, exc)
        self._wd_beat = time.perf_counter()
        return out

    def _chunk_sync_faults(self) -> None:
        """The fault sites at a chunk's read-back (both decode paths)."""
        if self._fi.fire("chunk_latency"):
            time.sleep(self._fi.latency_s("chunk_latency"))
        if self._fi.fire("chunk_sync_exc"):
            raise FaultInjected("chunk_sync_exc")
        if self._fi.fire("crash_at"):
            os._exit(137)              # hard mid-stream death, no cleanup

    def _st_decode_sync(self, pf, msg):
        t0 = time.perf_counter()
        kind, payload = msg
        if kind == "admit":
            if self.paged:
                self._merge_group(pf, payload)
            else:
                self._merge_group_slots(pf, payload)
        self._sweep_seated(pf)
        if self.paged:
            tg0 = time.perf_counter()
            self._cow_guard(pf)
            self._window_prefill_step(pf)
            self._grow_or_preempt(pf)
            if self._tr is not None:
                self._tr.add("growth", TRACK_ENGINE, tg0,
                             time.perf_counter())
        elif any(r is not None for r in self._slot_req):
            # the slot path's preempt site, consulted only in cycles with a
            # seated row: a lone row's admission cycle and the two pump
            # cycles minted behind it make a period of PIPELINE_LINES,
            # which every=3 would otherwise hit on every admission
            self._fault_preempt(pf)
        rem_before = self._rem.copy()
        if not (rem_before > 0).any():
            self._log("decode", pf.token, 0)
            return ("cycle", (self._reset_epoch, self._collect_finished()))
        n = self.decode_chunk
        t1 = time.perf_counter()
        self._chunk.carry.copy_(torch.from_numpy(
            np.stack([self._lengths, self._last, self._rem])))
        self._chunk.run()
        t1b = time.perf_counter()   # carry copy + one replay (host enqueue)
        if self._fi is not None:
            self._chunk_sync_faults()
        # the chunk's one device sync: tokens and the advanced carry in a
        # single copy back
        host = self._chunk.out.to("cpu", copy=True).numpy()
        t2a = time.perf_counter()
        toks = host[:, :n]
        self._lengths = host[:, n].copy()
        self._last = host[:, n + 1].copy()
        self._rem = host[:, n + 2].copy()
        t2 = time.perf_counter()
        emitted = 0
        for b in np.nonzero(rem_before > 0)[0]:
            k = int(min(n, rem_before[b]))
            self._slot_out[b].extend(toks[b, :k].tolist())
            emitted += k
        with self._state_lock:
            self.stats["decode_cycles"] += 1
            self.stats["tokens_out"] += emitted
        retire = self._collect_finished()
        t3 = time.perf_counter()
        self._note_rate(emitted, t3 - t0)
        if self._mh is not None:
            # dispatch = host enqueue; sync = the wait at the token read-
            # back; book = host work with nothing queued on the device
            mh = self._mh
            book = (t1 - t0) + (t2 - t2a) + (t3 - t2)
            mh["cycle"].record(t3 - t0)
            mh["dispatch"].record(t1b - t1)
            mh["sync"].record(t2a - t1b)
            mh["book"].record(book)
            mh["gap"].record(book)
            mh["chunk"].record(t2a - t1)
            mh["tokens_out"].inc(emitted)
        if self._tr is not None:
            tr = self._tr
            tr.add("cycle", TRACK_ENGINE, t0, t3, {"emitted": emitted})
            tr.add("dispatch", TRACK_ENGINE, t1, t1b)
            tr.add("sync", TRACK_ENGINE, t1b, t2a)
            tr.add("bookkeeping", TRACK_ENGINE, t2a, t3)
        self._log("decode", pf.token, (emitted, t3 - t1))
        return ("cycle", (self._reset_epoch, retire))

    def _st_decode_async(self, pf, msg):
        """Async decode lookahead (depth 2): dispatch chunk N+1 FIRST (one
        replay queued behind the chunk in flight), then wait for chunk N's
        tokens and do the host bookkeeping (emit, retire, advance the
        fence) while N+1 runs. Merges, window launches and growth are
        sequenced before the dispatch; a finished row retires one chunk
        late; tokens of a row whose seat changed since its chunk's dispatch
        are discarded (seat generation)."""
        t0 = time.perf_counter()
        kind, payload = msg
        pend = self._pending
        # read for the gap metric only (each torch call costs host time)
        device_idle = self._mh is not None \
            and (pend is None or pend["ev"] is None or pend["ev"].query()) \
            and self._window_pending is None
        # ---- pre-dispatch: everything chunk N+1 must observe ----
        wpend, self._window_pending = self._window_pending, None
        if wpend is not None:
            self._finish_window(wpend)
        if kind == "admit":
            if self.paged:
                self._merge_group(pf, payload)
            else:
                self._merge_group_slots(pf, payload)
        self._sweep_seated(pf)
        if self.paged:
            tg0 = time.perf_counter()
            self._cow_guard(pf)
            self._window_pending = self._dispatch_window_prefill(pf)
            self._grow_or_preempt(pf)
            if self._tr is not None:
                self._tr.add("growth", TRACK_ENGINE, tg0,
                             time.perf_counter())
        elif any(r is not None for r in self._slot_req):
            # the slot path's preempt site, consulted only in cycles with a
            # seated row: a lone row's admission cycle and the two pump
            # cycles minted behind it make a period of PIPELINE_LINES,
            # which every=3 would otherwise hit on every admission
            self._fault_preempt(pf)
        # ---- dispatch chunk N+1 ----
        n = self.decode_chunk
        new_pend = None
        t1 = time.perf_counter()
        if (self._rem > 0).any():
            rem_before = self._rem.copy()
            self._chunk.run()
            # chunk N+1's tokens into the pinned buffer N's did not use
            # (the next replay overwrites the graph's output)
            buf = self._tok_host[self._tok_i]
            self._tok_i ^= 1
            host, ev = self._link.read(self._chunk.out, into=buf)
            # the host mirrors advance by arithmetic (a chunk's length and
            # rem updates do not depend on its tokens); ``last`` is read
            # on the device only
            adv = np.minimum(n, rem_before)
            self._lengths += adv
            self._rem -= adv
            new_pend = {"host": host, "ev": ev, "rem_before": rem_before,
                        "gen": self._slot_gen.copy(), "token": pf.token}
            with self._state_lock:
                self.stats["decode_cycles"] += 1
            self._log("dispatch", pf.token, int((rem_before > 0).sum()))
        t2 = time.perf_counter()
        # ---- sync chunk N + bookkeeping (overlaps N+1 on the device) ----
        emitted = 0
        wait_s = 0.0
        ts = t2
        if pend is not None:
            ts = time.perf_counter()
            if self._fi is not None:
                self._chunk_sync_faults()
            toks = HostLink.wait(pend["host"], pend["ev"])[:, :n]
            wait_s = time.perf_counter() - ts
            for b in np.nonzero(pend["rem_before"] > 0)[0]:
                if self._slot_gen[b] != pend["gen"][b]:
                    continue    # seat changed since dispatch: surplus tokens
                k = int(min(n, pend["rem_before"][b]))
                self._slot_out[b].extend(toks[b, :k].tolist())
                emitted += k
            with self._state_lock:
                self.stats["tokens_out"] += emitted
            self._log("sync", pf.token, (pend["token"], emitted))
        self._pending = new_pend
        retire = self._collect_finished()
        if self.paged and (pend is not None or (
                new_pend is None and self._window_pending is None)):
            # fence advance: a chunk was synced (or nothing is in flight)
            # -- blocks deferred two advances ago are past every device
            # write that could touch them
            self._pool.release_deferred()
        t3 = time.perf_counter()
        self._note_rate(emitted, t3 - t0)
        if self._mh is not None:
            mh = self._mh
            gap = 0.0
            if device_idle:
                gap += t1 - t0      # nothing in flight during pre-dispatch
            if new_pend is None:
                gap += t3 - t2 - wait_s   # nor during the bookkeeping
            mh["cycle"].record(t3 - t0)
            mh["dispatch"].record(t2 - t1)
            mh["sync"].record(wait_s)
            mh["book"].record((t1 - t0) + (t3 - t2 - wait_s))
            mh["gap"].record(gap)
            mh["tokens_out"].inc(emitted)
        if self._tr is not None:
            tr = self._tr
            tr.add("cycle", TRACK_ENGINE, t0, t3, {"emitted": emitted})
            if new_pend is not None:
                tr.add("dispatch", TRACK_ENGINE, t1, t2)
            if pend is not None:
                tr.add("sync", TRACK_ENGINE, ts, ts + wait_s)
            tr.add("bookkeeping", TRACK_ENGINE, t2, t3)
        self._log("decode", pf.token, emitted)
        return ("cycle", (self._reset_epoch, retire))

    def _collect_finished(self) -> List[tuple]:
        """Rows that hit rem == 0: detach them from the batch (their slot
        stays reserved until complete frees it) and zero their mirrors and
        device table rows — the read paths bound their page loop by each
        row's length, so a retired slot must not keep advertising it.

        Async retires one chunk late: a row still active in the chunk just
        dispatched waits for the next cycle, and the zeroing writes (table
        and carry rows) land after that chunk, in which the row is already
        inactive."""
        pend = self._pending
        retire = []
        zero_rows = []
        for b in range(len(self._rem)):
            if self._slot_req[b] is None or self._slot_phase[b] != "decode" \
                    or self._rem[b] != 0:
                continue
            if self.paged and self._stall_rem[b] > 0:
                continue        # stalled for blocks, not finished
            if pend is not None and pend["rem_before"][b] > 0:
                continue        # active in the chunk in flight: next cycle
            req = self._slot_req[b]
            out = np.asarray(self._slot_out[b], np.int32)
            with self._state_lock:
                self._slot_req[b] = None
                self._slot_out[b] = None
                self._slot_phase[b] = None
            self._slot_gen[b] += 1
            self._lengths[b] = 0
            self._last[b] = 0
            if self.paged:
                self._tables[b] = 0
                self._pref_pos[b] = 0
                self._slot_prompt[b] = None
            zero_rows.append(b)
            retire.append((b, req, out))
            if self._tr is not None:
                _t = time.perf_counter()
                self._phase_end(b, _t, req)
                self._tr.instant("retired", f"slot{b}", _t,
                                 {"req": req.id, "tokens": len(out)})
        if zero_rows and (self.paged or self.async_decode):
            self._clear_rows_dev(zero_rows)
        return retire

    def _st_complete(self, pf, msg):
        _, (epoch, retire) = msg
        now = time.perf_counter()
        for slot, req, out in retire:
            # a retiree's tokens are valid whatever happened since; its
            # blocks and slot go back only if no failure-isolation reset
            # replaced the pool since its decode stage collected it (the
            # check and the frees are atomic against the reset's swap)
            self._scheduler.finish(req, out, now)
            with self._state_lock:
                self._inflight.discard(req)
                self.stats["retired"] += 1
                if epoch == self._reset_epoch:
                    if self.paged:
                        self._pool.free(self._slot_blocks[slot])
                        self._slot_blocks[slot] = None
                    self._free_slots.append(slot)
        self._wd_beat = now
        with self._state_lock:
            self._cycle_tokens.discard(pf.token)
        if retire and self._mh is not None:
            self._mh["retired"].inc(len(retire))
            self._note_resident()
        self._log("complete", pf.token, len(retire))
        return None

    # --------------------------------------------------------------- pumping
    def _pump(self) -> None:
        ex = self._ensure_executor()
        pl = self._ensure_pipeline()
        with self._pump_lock:
            if self._broken is not None or not pl.idle():
                return
            with self._state_lock:
                occupied = any(r is not None for r in self._slot_req)
            if self._scheduler.num_waiting == 0 and not occupied:
                return
            pl.run(ex, self._on_topo_done)

    def _on_topo_done(self, topo) -> None:
        if topo.exceptions:
            err = topo.exceptions[0]
            self._broken = err
            self._fail_outstanding(err)
            return
        if self._scheduler.num_waiting:
            self._pump()   # a submit raced the stop-drain: re-arm

    def _fail_outstanding(self, err: BaseException) -> None:
        self._scheduler.fail_all_waiting(err)
        with self._state_lock:
            live = list(self._inflight)  # admitted: slotted or pre-merge
            self._inflight.clear()
        for r in live:
            r.set_error(err)

    # ----------------------------------------------------------- client API
    def _shed_budget_for(self, tier: int) -> Optional[float]:
        """The shed budget of ``tier``: a scalar budget holds for every
        tier, a dict for its listed tiers only."""
        b = self._shed_budget
        if b is None:
            return None
        if isinstance(b, dict):
            v = b.get(tier)
            return float(v) if v is not None else None
        return float(b)

    def _note_rate(self, emitted: int, dt: float) -> None:
        """Fold one decode cycle into the service rate: emitted tokens over
        the cycle's wall time. Cycles that emitted nothing are skipped
        (their cost is inside their neighbours' wall time)."""
        if emitted <= 0 or dt <= 0.0:
            return
        r = emitted / dt
        a = self._rate_alpha
        self._decode_rate = r if self._decode_rate == 0.0 \
            else (1.0 - a) * self._decode_rate + a * r

    def _estimated_wait_s(self, priority: int) -> Optional[float]:
        """Queue-wait estimate of a new request at ``priority``: the
        resident rows' remaining steps (stalled balances included) plus the
        ``max_new`` waiting at tiers <= ``priority``, over the service rate.
        Until the first tokens: the p90 of ``serve.queue_wait_s`` (after 8
        admissions) times the backlog in admission waves. None without
        either signal (a cold engine never sheds)."""
        rate = self._decode_rate
        if rate > 0.0:
            resident = 0
            # lock-free mirror reads: at worst one cycle stale
            for b in range(len(self._rem)):
                if self._slot_req[b] is None:
                    continue
                resident += int(self._rem[b])
                if self.paged:
                    resident += int(self._stall_rem[b])
            backlog = self._scheduler.waiting_tokens_upto(priority)
            return (resident + backlog) / rate
        if self._mh is None:
            return None
        h = self._mh["qwait"]
        if h.count < 8:
            return None
        base = h.percentile(90.0)
        backlog = self._scheduler.num_waiting_upto(priority)
        waves = 1.0 + backlog / float(self._scheduler.max_admit)
        return base * waves

    def _hopeless_why(self, r: ServeRequest) -> Optional[str]:
        """Deadline check at the admission head: a request whose remaining
        budget cannot cover its prefill and decode at the service rate
        fails typed :class:`DeadlineExceeded` before it takes a slot. With
        no rate yet nothing is hopeless."""
        if r.deadline_at is None:
            return None
        rate = self._decode_rate
        if rate <= 0.0:
            return None
        remaining = r.deadline_at - time.perf_counter()
        est = (r.prompt_len + r.max_new) / rate
        if est <= remaining:
            return None
        return (f"hopeless at admission: estimated prefill+decode "
                f"{est:.3f}s exceeds the remaining deadline budget "
                f"{remaining:.3f}s at the observed service rate "
                f"{rate:.1f} tok/s")

    def submit(self, prompt, max_new: int = 16, *,
               priority: int = 0,
               deadline_s: Optional[float] = None) -> ServeRequest:
        """Enqueue one greedy generation request on the resident pipeline
        and return its future. Thread-safe; callable while earlier requests
        are mid-decode. ``priority`` is the scheduling tier (0 = highest;
        the preemption cost model victimizes the highest tier first).
        ``deadline_s`` bounds the request's latency from now: past it the
        request fails typed :class:`DeadlineExceeded`, queued or seated,
        and its seat is reclaimed. With a shed budget for the tier, an
        estimated queue wait over the budget (or over ``deadline_s``)
        raises :class:`Overloaded` here, before the request queues."""
        if self._broken is not None:
            raise RuntimeError("serve pipeline is broken") from self._broken
        if self._closing:
            raise EngineClosed("engine is closed")
        req = ServeRequest(prompt, max_new, priority=priority,
                           deadline_s=deadline_s)
        total = req.prompt_len + req.max_new
        if total > self._max_seq:
            raise ValueError(
                f"prompt+max_new = {total} exceeds max_seq_len "
                f"{self._max_seq}")
        budget = self._shed_budget_for(req.priority)
        if budget is not None:
            est = self._estimated_wait_s(req.priority)
            limit = budget if deadline_s is None \
                else min(budget, deadline_s)
            if est is not None and est > limit:
                with self._state_lock:
                    self.stats["shed"] += 1
                if self._mh is not None:
                    self._mh["shed"].inc()
                depth = self._scheduler.num_waiting_upto(req.priority)
                raise Overloaded(
                    f"request shed at submit: estimated queue wait "
                    f"{est:.3f}s exceeds the tier-{req.priority} budget "
                    f"{limit:.3f}s (backlog {depth} at tiers <= "
                    f"{req.priority})",
                    tier=req.priority, est_wait_s=est, budget_s=limit,
                    queue_depth=depth)
        now = time.perf_counter()
        req.submitted_at = now
        if req.deadline_s is not None:
            req.deadline_at = now + req.deadline_s
        self._wd_beat = now
        self._scheduler.enqueue(req)
        self._pump()
        return req

    def result(self, req: ServeRequest,
               timeout: Optional[float] = 300.0) -> np.ndarray:
        return req.result(timeout)

    def generate(self, prompts: List[Any], max_new: int) -> List[Any]:
        """Submit every prompt, gather results in input order."""
        if not prompts:
            return []
        reqs = [self.submit(p, max_new) for p in prompts]
        return [self.result(r, timeout=600.0) for r in reqs]


def write_slot_state(sstate, slot: int, cache, plen: int) -> None:
    """Copy a B=1 prefill cache into ``slot`` of a slot-state pool, in
    place (the reference engine's ``_write_slot_state``): per-layer ``(conv,
    h)`` and, for zamba2, the prompt's ``plen`` positions of each group's
    KV span (later positions keep a previous occupant's values, which the
    row's mask never reads before its own writes replace them)."""
    if "g_ssm" in sstate:
        for dst, src in zip(sstate["g_ssm"], cache["g_ssm"]):
            dst[:, :, slot].copy_(src[:, :, 0])
        for dst, src in zip(sstate.get("tail_ssm", ()),
                            cache.get("tail_ssm", ())):
            dst[:, slot].copy_(src[:, 0])
        for name in ("shared_k", "shared_v"):
            sstate[name][:, slot, :, :plen].copy_(cache[name][:, 0])
    else:
        for dst, src in zip(sstate["ssm"], cache["ssm"]):
            dst[:, slot].copy_(src[:, 0])


def _tensors(tree):
    """Every tensor in a nest of dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _leaves(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v

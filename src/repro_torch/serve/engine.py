"""Continuously-batched serving engine of the port: a RESIDENT 4-stage
Taskflow pipeline fed by a request queue, with TWO-PHASE memory admission.

This is the synchronous, single-device subset of the reference
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

Failure: an exception in any stage cancels the pipeline topology, fails
every outstanding request future (``result()`` raises instead of hanging)
and marks the engine broken.

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
bookkeeping seconds, pool and queue gauges). On CUDA ``engine.dispatch_s``
is host enqueue time (carry upload and the chunk's launches) and
``engine.chunk_sync_s`` the wait at the chunk's only sync, the token read-
back; the engine adds no synchronisation for them. Disabled, each site
costs one ``is None`` check.

Not in this slice (queued in ROADMAP.md): async decode lookahead, SLO
shedding/deadlines/watchdog, fault injection, journal/snapshot/drain/
recover, meshes, the checkpoint preemption of SSM and hybrid slots and the
per-call grouped baseline. The engine raises :class:`UnsupportedArch` on
archs it cannot serve yet (modality frontends).
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
from .errors import EngineClosed, ServeError
from .kvcache import (BlockPool, copy_blocks, extend_block_tables,
                      init_kv_pool, scatter_prefill_rows, set_table_rows)
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
        self._closing = False
        self._broken: Optional[BaseException] = None
        self._stage_log = [] if record_stages else None
        self._log_lock = threading.Lock()

        B = max_batch
        self._scheduler = Scheduler(max_admit=max_admit)
        # slot state: written by the SERIAL decode stage (merge/window/grow/
        # step) and the complete stage (free) under _state_lock
        self._lengths = np.zeros((B,), np.int32)   # KV tokens written
        self._rem = np.zeros((B,), np.int32)       # decode steps remaining
        self._last = np.zeros((B,), np.int32)      # last emitted token
        self._slot_req: List[Optional[ServeRequest]] = [None] * B
        self._slot_out: List[Optional[List[int]]] = [None] * B
        self._slot_phase: List[Optional[str]] = [None] * B  # prefill|decode
        self._free_slots = list(range(B - 1, -1, -1))
        self._slots_reserved = 0       # admitted but not yet merged
        self._inflight: set = set()    # admitted, not yet retired
        self._cycle_tokens: set = set()  # cycles minted, not yet completed
        self._state_lock = threading.Lock()
        self._pump_lock = threading.Lock()
        self._pipeline: Optional[DataPipeline] = None
        self.stats = {"admitted": 0, "admit_parks": 0, "pump_cycles": 0,
                      "decode_cycles": 0, "prefills": 0,
                      "prefill_windows": 0, "tokens_out": 0, "retired": 0,
                      "grown_blocks": 0, "preempted": 0, "stalls": 0,
                      "prefix_hits": 0, "prefix_tokens_saved": 0,
                      "cow_forks": 0}

        self._prefix: Optional[PrefixCache] = None
        if self.paged:
            self._init_paged(B, kv_blocks, block_size, max_seq_len,
                             prefill_chunk)
        else:
            self._init_slots(B, max_seq_len)
        # observability: one open phase span per seated slot (name, t0);
        # None obs = disabled (every site guards on self._tr / self._mh)
        self._slot_span: List[Optional[tuple]] = [None] * B
        self.set_obs(obs if obs is not None else _obs_from_env())

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
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
        return bool(self._inflight) or bool(self._cycle_tokens) \
            or self._scheduler.num_waiting > 0

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
        if self._busy():
            self._fail_outstanding(EngineClosed(
                "engine closed with requests outstanding "
                "(drain timeout or prior failure)"))
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
            popped = self._scheduler.try_admit(free_slots, None)
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
                self._slots_reserved += len(group)
                self._inflight.update(g[0] for g in group)
                self._cycle_tokens.add(pf.token)
                self.stats["admitted"] += len(group)
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
        popped = self._scheduler.try_admit(free_slots, budget, need_for)
        if popped is None:
            return None
        # pin the longest cached prefix per member (a reference on every
        # matched block) and allocate only the uncached suffixes
        hits = [px.match_and_pin(r.prompt) if px is not None else None
                for r in popped]
        needs = [self._pool.blocks_for(r.prompt_len)
                 - (len(h.blocks) if h is not None else 0)
                 for r, h in zip(popped, hits)]
        ids = self._pool.alloc(sum(needs))      # all-or-nothing
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
            return self._prefill_group(pf, payload)

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
            out = []
            for req in reqs:
                logits, cache = lm.prefill(
                    self.cfg, self.params, self._to_dev(req.prompt[None]),
                    layers=self._layers)
                out.append((req, cache, int(torch.argmax(logits[0]))))
            with self._state_lock:
                self.stats["prefills"] += len(reqs)
            self._log("prefill", pf.token, [r.id for r in reqs])
            return ("admit", out)
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
        logits, cache = lm.prefill(self.cfg, self.params, self._to_dev(toks),
                                   max_len=C0,
                                   last_positions=self._to_dev(lastp),
                                   layers=self._layers)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
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
        block."""
        group, C0, ck, cv, first, n_miss = payload
        first = first.cpu().numpy() if first is not None else None
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
                       self._to_dev(np.asarray(rows_idx, np.int32)),
                       self._to_dev(np.stack(rows_tab)))
        if fork_src:
            # one copy for the group's forks, unpadded: its destinations are
            # distinct fresh blocks (duplicate destinations of an indexed
            # copy would be written in no set order on CUDA)
            copy_blocks(self._pkv, self._to_dev(np.asarray(fork_src,
                                                           np.int32)),
                        self._to_dev(np.asarray(fork_dst, np.int32)))
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
        self._note_resident()

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

    def _merge_group_slots(self, payload) -> None:
        """Seat an admitted slot-state group: copy each member's prefilled
        state into its slot of the state pool and start it decoding from
        its first token."""
        now = time.perf_counter()
        for req, cache, first in payload:
            with self._state_lock:
                slot = self._free_slots.pop()
                self._slots_reserved -= 1
                self._slot_req[slot] = req
                self._slot_out[slot] = [first]
                self._slot_phase[slot] = "decode"
            write_slot_state(self._sstate, slot, cache, req.prompt_len)
            self._lengths[slot] = req.prompt_len
            self._last[slot] = first
            self._rem[slot] = req.max_new - 1
            self._note_first_token(req, now)
            req.state = "decoding"
            if self._tr is not None:
                self._note_seated(slot, req, now)
        self._note_resident()

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
        prefill window for every mid-prefill row in the same cycle (the
        reference's async engine completes the window a cycle later; that
        path comes with the async slice)."""
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
            self._to_dev(toks), self._to_dev(start), self._to_dev(valid),
            self._to_dev(last_idx), layers=self._layers)
        with self._state_lock:
            self.stats["prefill_windows"] += 1
        return {"first": first, "rows": pref, "k": ks, "token": pf.token,
                "t_disp": time.perf_counter()}

    def _finish_window(self, pend: dict) -> None:
        """Complete a dispatched prefill window: advance per-row prompt
        positions and flip rows whose prompt just finished into decode,
        seeded by their first token."""
        first = pend["first"].cpu().numpy()
        now = time.perf_counter()
        for b in pend["rows"]:
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
        self._log("prefill_chunk", pend["token"],
                  [(b, int(self._pref_pos[b])) for b in pend["rows"]])

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
        blocks = self._slot_blocks[v]
        held = len(blocks) if blocks is not None else 0
        return (-req.priority, produced - held, req.preempted_count,
                -req.id)

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
        grow_rows: List[int] = []
        grow_cols: List[int] = []
        grow_ids: List[int] = []
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
                ids = self._pool.grow_table(self._slot_blocks[b], need - cur,
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
                    if self._tr is not None:
                        _t = time.perf_counter()
                        self._phase_end(b, _t, self._slot_req[b])  # stalled
                        self._phase_begin(b, "decode", _t)
                    self._log("resume", pf.token, b)
            elif self._rem[b] > 0:
                # newly stalled: mask the row out of the next chunk
                self._stall_rem[b] = int(self._rem[b])
                self._rem[b] = 0
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
        if grow_rows:
            self._log("grow", pf.token, list(zip(grow_rows, grow_ids)))
            extend_block_tables(
                self._tables_dev,
                self._to_dev(np.asarray(grow_rows, np.int32)),
                self._to_dev(np.asarray(grow_cols, np.int32)),
                self._to_dev(np.asarray(grow_ids, np.int32)))

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
                # it alive, so nothing is released here)
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
            copy_blocks(self._pkv, self._to_dev(np.asarray(srcs, np.int32)),
                        self._to_dev(np.asarray(dsts, np.int32)))
            extend_block_tables(
                self._tables_dev,
                self._to_dev(np.asarray([rows[j] for j in live], np.int32)),
                self._to_dev(np.asarray([cols[j] for j in live], np.int32)),
                self._to_dev(np.asarray(dsts, np.int32)))

    def _preempt(self, slot: int, pf) -> None:
        req = self._slot_req[slot]
        with self._state_lock:
            self._slot_req[slot] = None
            self._slot_out[slot] = None
            self._slot_phase[slot] = None
            self._pool.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = None
            self._free_slots.append(slot)
            self._inflight.discard(req)
            self.stats["preempted"] += 1
        req.preempted_count += 1
        self._lengths[slot] = 0
        self._last[slot] = 0
        self._rem[slot] = 0
        self._slot_prompt[slot] = None
        self._wp_valid[slot] = False
        self._tables[slot] = 0
        self._stall_rem[slot] = 0
        self._pref_pos[slot] = 0
        set_table_rows(self._tables_dev,
                       self._to_dev(np.asarray([slot], np.int32)),
                       self._to_dev(np.zeros((1, self._tables.shape[1]),
                                             np.int32)))
        if self._mh is not None:
            self._mh["preempted"].inc()
            self._note_resident()
        if self._tr is not None:
            _t = time.perf_counter()
            self._phase_end(slot, _t, req)
            self._tr.instant("preempted", f"slot{slot}", _t, {"req": req.id})
        self._scheduler.requeue_front([req])
        self._log("preempt", pf.token, req.id)

    def _st_decode(self, pf, msg):
        with self._stage_ctx():
            return self._st_decode_sync(pf, msg)

    def _st_decode_sync(self, pf, msg):
        t0 = time.perf_counter()
        kind, payload = msg
        if kind == "admit":
            if self.paged:
                self._merge_group(pf, payload)
            else:
                self._merge_group_slots(payload)
        if self.paged:
            tg0 = time.perf_counter()
            self._cow_guard(pf)
            self._window_prefill_step(pf)
            self._grow_or_preempt(pf)
            if self._tr is not None:
                self._tr.add("growth", TRACK_ENGINE, tg0,
                             time.perf_counter())
        rem_before = self._rem.copy()
        if not (rem_before > 0).any():
            self._log("decode", pf.token, 0)
            return ("cycle", self._collect_finished())
        n = self.decode_chunk
        t1 = time.perf_counter()
        carry = self._to_dev(np.stack([self._lengths, self._last,
                                       self._rem]))
        carry = (carry[0], carry[1], carry[2])
        if self.paged:
            _, (ln, tok, rm), toks = lm.decode_chunk_paged(
                self.cfg, self.params, self._pkv, self._tables_dev, carry, n,
                impl=self.paged_impl, layers=self._layers)
        else:
            _, (ln, tok, rm), toks = lm.decode_chunk_slots(
                self.cfg, self.params, self._sstate, carry, n,
                layers=self._layers)
        t1b = time.perf_counter()   # carry upload + launches (host enqueue)
        # the chunk's one device sync: tokens and the advanced carry in a
        # single copy back
        host = torch.cat([toks, torch.stack([ln, tok, rm], dim=1)],
                         dim=1).cpu().numpy()
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
        return ("cycle", retire)

    def _collect_finished(self) -> List[tuple]:
        """Rows that hit rem == 0: detach them from the batch (their slot
        stays reserved until complete frees it) and zero their mirrors and
        device table rows — the read paths bound their page loop by each
        row's length, so a retired slot must not keep advertising it."""
        retire = []
        zero_rows = []
        for b in range(len(self._rem)):
            if self._slot_req[b] is None or self._slot_phase[b] != "decode" \
                    or self._rem[b] != 0:
                continue
            if self.paged and self._stall_rem[b] > 0:
                continue        # stalled for blocks, not finished
            req = self._slot_req[b]
            out = np.asarray(self._slot_out[b], np.int32)
            with self._state_lock:
                self._slot_req[b] = None
                self._slot_out[b] = None
                self._slot_phase[b] = None
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
        if zero_rows and self.paged:
            set_table_rows(self._tables_dev,
                           self._to_dev(np.asarray(zero_rows, np.int32)),
                           self._to_dev(np.zeros(
                               (len(zero_rows), self._tables.shape[1]),
                               np.int32)))
        return retire

    def _st_complete(self, pf, msg):
        _, retire = msg
        now = time.perf_counter()
        for slot, req, out in retire:
            self._scheduler.finish(req, out, now)
            with self._state_lock:
                self._inflight.discard(req)
                self.stats["retired"] += 1
                if self.paged:
                    self._pool.free(self._slot_blocks[slot])
                    self._slot_blocks[slot] = None
                self._free_slots.append(slot)
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
    def submit(self, prompt, max_new: int = 16, *,
               priority: int = 0) -> ServeRequest:
        """Enqueue one greedy generation request on the resident pipeline
        and return its future. Thread-safe; callable while earlier requests
        are mid-decode. ``priority`` is the scheduling tier (0 = highest;
        the preemption cost model victimizes the highest tier first)."""
        if self._broken is not None:
            raise RuntimeError("serve pipeline is broken") from self._broken
        if self._closing:
            raise EngineClosed("engine is closed")
        req = ServeRequest(prompt, max_new, priority=priority)
        total = req.prompt_len + req.max_new
        if total > self._max_seq:
            raise ValueError(
                f"prompt+max_new = {total} exceeds max_seq_len "
                f"{self._max_seq}")
        req.submitted_at = time.perf_counter()
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


def _leaves(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v

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

Not in this slice (queued in ROADMAP.md): async decode lookahead, the
prefix cache and its copy-on-write guard, SLO shedding/deadlines/watchdog,
fault injection, journal/snapshot/drain/recover, observability, meshes, the
checkpoint preemption of SSM and hybrid slots and the per-call grouped
baseline. The engine raises :class:`UnsupportedArch` on archs it cannot
serve yet (modality frontends).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import ACCEL, HOST, Executor
from ..device import resolve_device
from ..kernels.ops import PAGED_IMPLS, default_paged_impl, ensure_built
from ..models import lm
from ..pipeline import DataPipe, DataPipeline, PipeType
from .errors import EngineClosed, ServeError
from .kvcache import (BlockPool, extend_block_tables, init_kv_pool,
                      scatter_prefill_rows, set_table_rows)
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
    record_stages:
        keep an in-memory (stage, cycle-token, info, t) event log.
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
                 record_stages: bool = False,
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
                      "grown_blocks": 0, "preempted": 0, "stalls": 0}

        if self.paged:
            self._init_paged(B, kv_blocks, block_size, max_seq_len,
                             prefill_chunk)
        else:
            self._init_slots(B, max_seq_len)

    def _init_paged(self, B: int, kv_blocks: int, block_size: int,
                    max_seq_len: Optional[int],
                    prefill_chunk: Optional[int]) -> None:
        self._pool = BlockPool(kv_blocks, block_size)
        self._pkv = init_kv_pool(self.cfg, kv_blocks, block_size,
                                 self.device)
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
            for r, _ in group:
                r.state = "prefilling"
                if r.admitted_at is None:
                    r.admitted_at = now
            with self._state_lock:
                self._slots_reserved += len(group)
                self._inflight.update(r for r, _ in group)
                self._cycle_tokens.add(pf.token)
                self.stats["admitted"] += len(group)
            self._log("admit", pf.token, [r.id for r, _ in group])
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
        self._log("pump", pf.token, None)
        return ("pump", None)

    def _admit_paged(self, free_slots: int) -> Optional[List[tuple]]:
        """Phase 1 of two-phase admission: budget the PROMPT footprint only;
        decode-time blocks are granted lazily by the decode stage. The
        budget excludes the stalled-row reservation floor."""
        def need_for(r):
            return self._pool.blocks_for(r.prompt_len)
        popped = self._scheduler.try_admit(free_slots,
                                           self._pool.num_free_unreserved,
                                           need_for)
        if popped is None:
            return None
        needs = [need_for(r) for r in popped]
        ids = self._pool.alloc(sum(needs))      # all-or-nothing
        if ids is None:
            # raced a concurrent mid-decode grow: put the group back
            self._scheduler.requeue_front(popped)
            return None
        group, i = [], 0
        for r, need in zip(popped, needs):
            group.append((r, ids[i:i + need]))
            i += need
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
        Slot-state: one whole-prompt prefill per member at B=1 (the state
        is O(1) per sequence; there is no per-token KV to window)."""
        reqs = [r for r, _ in group]
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
        longest = max(r.prompt_len for r in reqs)
        C0 = min(self.prefill_chunk, 1 << max(0, longest - 1).bit_length())
        A = self._scheduler.max_admit
        toks = np.zeros((A, C0), np.int32)
        lastp = np.zeros((A,), np.int32)
        for i, r in enumerate(reqs):
            k = min(r.prompt_len, C0)
            toks[i, :k] = r.prompt[:k]
            lastp[i] = k - 1
        for i in range(len(reqs), A):
            toks[i] = toks[len(reqs) - 1]
            lastp[i] = lastp[len(reqs) - 1]
        logits, cache = lm.prefill(self.cfg, self.params, self._to_dev(toks),
                                   max_len=C0,
                                   last_positions=self._to_dev(lastp),
                                   layers=self._layers)
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        with self._state_lock:
            self.stats["prefills"] += 1
        self._log("prefill", pf.token, [r.id for r in reqs])
        return ("admit", (group, C0, cache["k"], cache["v"], first))

    # ------------------------------------------------- decode-stage helpers
    def _merge_group(self, pf, payload) -> None:
        """Seat an admitted group: assign slots, install block tables, and
        scatter the window-0 KV into the pool. Rows whose whole prompt fits
        window 0 enter decode immediately; longer ones enter the prefill
        phase and stream their remaining windows in later cycles."""
        group, C0, ck, cv, first = payload
        first = first.cpu().numpy()
        nb0 = self._pool.blocks_for(C0)
        now = time.perf_counter()
        rows_idx, rows_tab = [], []
        for i, (req, blocks) in enumerate(group):
            tab = list(blocks)
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
            self._pref_pos[slot] = min(req.prompt_len, C0)
            self._lengths[slot] = self._pref_pos[slot]
            if req.prompt_len <= C0:
                self._slot_phase[slot] = "decode"
                self._last[slot] = first[i]
                self._rem[slot] = req.max_new - 1
                self._slot_out[slot].append(int(first[i]))
                req.state = "decoding"
                self._note_first_token(req, now)
            else:
                self._slot_phase[slot] = "prefill"
                self._last[slot] = 0
                self._rem[slot] = 0   # masked out of decode until prefilled
            rows_idx.append(slot)
            rows_tab.append(self._tables[slot].copy())
        set_table_rows(self._tables_dev,
                       self._to_dev(np.asarray(rows_idx, np.int32)),
                       self._to_dev(np.stack(rows_tab)))
        # window-0 scatter: per-row block lists trimmed/padded to the window
        # footprint (sink beyond a short prompt's own blocks and for the
        # group's pad rows)
        blocks2d = np.zeros((ck.shape[1], nb0), np.int32)
        for i, (_, blocks) in enumerate(group):
            row = blocks[:nb0]
            blocks2d[i, :len(row)] = row
        scatter_prefill_rows(self._pkv, self._to_dev(blocks2d), ck, cv)

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
            req.state = "decoding"
            self._note_first_token(req, now)

    def _note_first_token(self, req, now: float) -> None:
        if req.first_token_at is None:
            req.first_token_at = now

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
        return {"first": first, "rows": pref, "k": ks, "token": pf.token}

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
            if self._pref_pos[b] >= len(prompt):
                req = self._slot_req[b]
                self._slot_phase[b] = "decode"
                self._last[b] = first[b]
                self._rem[b] = req.max_new - 1
                self._slot_out[b].append(int(first[b]))
                req.state = "decoding"
                self._note_first_token(req, now)
                self._wp_valid[b] = False
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
                    covered = True
                    break
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
                    self._log("resume", pf.token, b)
            elif self._rem[b] > 0:
                # newly stalled: mask the row out of the next chunk
                self._stall_rem[b] = int(self._rem[b])
                self._rem[b] = 0
                with self._state_lock:
                    self.stats["stalls"] += 1
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
        self._scheduler.requeue_front([req])
        self._log("preempt", pf.token, req.id)

    def _st_decode(self, pf, msg):
        with self._stage_ctx():
            return self._st_decode_sync(pf, msg)

    def _st_decode_sync(self, pf, msg):
        kind, payload = msg
        if kind == "admit":
            if self.paged:
                self._merge_group(pf, payload)
            else:
                self._merge_group_slots(payload)
        if self.paged:
            self._window_prefill_step(pf)
            self._grow_or_preempt(pf)
        rem_before = self._rem.copy()
        if not (rem_before > 0).any():
            self._log("decode", pf.token, 0)
            return ("cycle", self._collect_finished())
        n = self.decode_chunk
        t0 = time.perf_counter()
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
        # the chunk's one device sync: tokens and the advanced carry in a
        # single copy back
        host = torch.cat([toks, torch.stack([ln, tok, rm], dim=1)],
                         dim=1).cpu().numpy()
        toks = host[:, :n]
        self._lengths = host[:, n].copy()
        self._last = host[:, n + 1].copy()
        self._rem = host[:, n + 2].copy()
        emitted = 0
        for b in np.nonzero(rem_before > 0)[0]:
            k = int(min(n, rem_before[b]))
            self._slot_out[b].extend(toks[b, :k].tolist())
            emitted += k
        with self._state_lock:
            self.stats["decode_cycles"] += 1
            self.stats["tokens_out"] += emitted
        retire = self._collect_finished()
        self._log("decode", pf.token, (emitted, time.perf_counter() - t0))
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

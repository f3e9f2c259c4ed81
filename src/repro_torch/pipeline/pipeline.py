"""Task-parallel pipeline scheduling framework (Pipeflow, arXiv:2202.00717).

The pipeline is the single most valuable client of the paper's in-graph
control flow (§3.4: condition tasks, weak edges, cycles): ``L`` parallel
*lines* times ``S`` *pipes* (stages) are laid out **once** as a static cyclic
grid of multi-condition tasks over the existing work-stealing
:class:`~repro.core.executor.Executor` — no dedicated pipeline threads, no
data copies, no graph rebuilding between tokens.

Mapping to the Pipeflow paper:

==========================  ===================================================
Pipeflow construct          Here
==========================  ===================================================
``tf::Pipeline(L, ...)``    :class:`Pipeline` — ``Pipeline(num_lines, *pipes)``
``tf::Pipe{SERIAL, fn}``    :class:`Pipe` / :class:`PipeType` (``SERIAL`` |
                            ``PARALLEL``); the first pipe must be SERIAL
``tf::Pipeflow``            :class:`Pipeflow` — the per-line worker view
                            (``pf.line``, ``pf.pipe``, ``pf.token``)
``pf.stop()``               :meth:`Pipeflow.stop` — in-stage termination: only
                            legal at the first pipe; in-flight tokens drain
scheduling tokens           per-(line, pipe) :class:`AtomicInt` join counters;
                            a token *t* runs on line ``t % L``
deferred lines              a line whose next SERIAL pipe is still occupied
                            parks (its task simply is not scheduled) instead
                            of blocking a worker; counted in
                            :attr:`Pipeline.num_deferrals`
``pf.defer(t)``             :meth:`Pipeflow.defer` — token-level deferral
                            (§deferred pipelines): the current token parks
                            at the first pipe until token ``t`` completes
                            the last pipe; in-flight tokens drain meanwhile
                            and no worker blocks. Admission pauses while
                            parked (mint order stays line-round-robin —
                            full Pipeflow token reordering needs dynamic
                            token->line binding, out of scope for the
                            static grid). Resume accounting in
                            :attr:`Pipeline.num_token_deferrals` /
                            :attr:`Pipeline.num_resumes`
``tf::DataPipeline``        :class:`repro.pipeline.data.DataPipeline` —
                            per-line buffers threaded between stages, no locks
==========================  ===================================================

Graph layout (the static cyclic TDG, built once per ``Pipeline``):

* one **multi-condition task per (line, pipe) slot**; slot ``(l, s)`` has two
  weak out-edges: index 0 → ``(l, (s+1) % S)`` (the line moves forward, the
  last pipe wraps to re-admit the line) and index 1 → ``((l+1) % L, s)`` (a
  SERIAL pipe hands the stage to the next token's line);
* one **condition task** (the source) whose integer return selects which
  line's first pipe admits the next token — this is the paper's weak-edge
  bypass: condition successors are scheduled directly, join counters are
  only decremented by the grid itself.

Every edge is weak, so the whole pipeline is a *cycle* in the TDG — exactly
the pattern Figure 6/§3.4 of the Taskflow paper legalises — and a pipeline
run completes (the topology's pending count reaches zero) precisely when a
stop signal has drained every in-flight token.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core.atomic import AtomicInt
from ..core.executor import Executor, Topology
from ..core.graph import HOST, Task, Taskflow

__all__ = ["PipeType", "Pipe", "Pipeflow", "Pipeline"]


class PipeType(enum.Enum):
    SERIAL = "serial"      # at most one line in the stage; strict token order
    PARALLEL = "parallel"  # any number of lines in the stage concurrently


class Pipe:
    """One pipeline stage: ``fn(pf: Pipeflow)`` run on ``domain`` workers."""

    __slots__ = ("kind", "fn", "name", "domain")

    def __init__(self, kind: PipeType, fn: Callable, name: str = "",
                 domain: str = HOST) -> None:
        self.kind = kind
        self.fn = fn
        self.name = name or getattr(fn, "__name__", kind.value)
        self.domain = domain


class Pipeflow:
    """Per-line view handed to every pipe callable (paper's ``tf::Pipeflow``)."""

    __slots__ = ("_line", "_pipe", "_token", "_stopped", "_defer_on",
                 "num_deferrals")

    def __init__(self, line: int) -> None:
        self._line = line
        self._pipe = 0
        self._token = 0
        self._stopped = False
        self._defer_on: Optional[int] = None
        self.num_deferrals = 0

    @property
    def line(self) -> int:
        return self._line

    @property
    def pipe(self) -> int:
        return self._pipe

    @property
    def token(self) -> int:
        return self._token

    def stop(self) -> None:
        """Stop admitting tokens. Only legal at the first pipe; the serial
        stage-0 hand-off chain is broken, so no later line re-enters pipe 0
        and all in-flight tokens drain to completion."""
        if self._pipe != 0:
            raise RuntimeError(
                "Pipeflow.stop() can only be called from the first pipe "
                f"(called from pipe {self._pipe})")
        self._stopped = True

    def defer(self, token: int) -> None:
        """Token-level deferral (Pipeflow §deferred pipelines): park THIS
        token until ``token`` has fully completed the last pipe, then re-run
        the first pipe body with the same token number.

        Only legal at the first pipe — the admission point. While parked,
        admission PAUSES (the parked token holds the SERIAL first pipe; the
        static grid's round-robin hand-off protocol ties mint order to
        lines, so later tokens do not overtake) but every in-flight token
        keeps draining its remaining stages, and no worker blocks — the
        park is pure scheduling state, which is what makes this the
        spin-free back-pressure primitive for admission control. Deferring
        on an already-completed token re-runs the stage body immediately.

        ``token`` must already have been minted (``token < num_tokens``;
        the current token mints only when its first pipe succeeds);
        deferring on a future token could wedge the drain protocol, so it
        raises.
        """
        if self._pipe != 0:
            raise RuntimeError(
                "Pipeflow.defer() can only be called from the first pipe "
                f"(called from pipe {self._pipe})")
        if token == self._token:
            raise ValueError(f"token {token} cannot defer on itself")
        self._defer_on = token


class Pipeline:
    """``L`` lines × ``S`` pipes scheduled purely by executor condition tasks.

    Parameters
    ----------
    num_lines:
        maximum number of tokens in flight (the paper's *parallel lines*).
    pipes:
        :class:`Pipe` objects in stage order; the first must be SERIAL.

    Use :meth:`run` (or ``executor.run(pipeline.taskflow)`` after
    :meth:`reset`) to execute. Token numbering is monotone across runs, so a
    drained pipeline can be re-armed with :meth:`reset` + :meth:`run` to
    continue the stream — the restart pattern the bounded
    :class:`repro.data.pipeline.Prefetcher` uses for back-pressure.
    """

    def __init__(self, num_lines: int, *pipes: Pipe, name: str = "pipeline"):
        if num_lines < 1:
            raise ValueError("pipeline needs at least one line")
        if not pipes:
            raise ValueError("pipeline needs at least one pipe")
        if pipes[0].kind is not PipeType.SERIAL:
            raise ValueError("the first pipe must be SERIAL "
                             "(it mints scheduling tokens, Pipeflow §3)")
        self._pipes: List[Pipe] = list(pipes)
        self._num_lines = num_lines
        self._pipeflows = [Pipeflow(l) for l in range(num_lines)]
        self._counters = [[AtomicInt(0) for _ in pipes]
                          for _ in range(num_lines)]
        # per-(line, pipe) cumulative wall time inside the stage body; a
        # slot runs exclusively (its join counter serialises visits), so
        # plain int accumulation is race-free
        self._stage_ns = [[0] * len(pipes) for _ in range(num_lines)]
        # optional repro.obs.Tracer: when set, every pipe-body interval is
        # also recorded as a span on a per-line track ("line0", "line1",
        # ...) — the stage_times aggregate, promoted to a timeline. Plain
        # attribute so callers can attach/detach between runs.
        self.tracer = None
        self._num_tokens = 0
        self._num_deferrals = AtomicInt(0)
        self._stopped = False
        self._start_line = 0
        self._topology: Optional[Topology] = None
        self._executor: Optional[Executor] = None
        # token-level deferral state (Pipeflow §deferred pipelines)
        self._defer_lock = threading.Lock()
        self._parked = [False] * num_lines
        self._deferred_waiters: Dict[int, List[int]] = {}  # dep -> lines
        self._completed_watermark = -1     # tokens <= this have completed
        self._completed_set: set = set()   # out-of-order completions
        self._num_token_deferrals = AtomicInt(0)
        self._num_resumes = AtomicInt(0)
        self._taskflow = Taskflow(name)
        self._build()
        self.reset()

    # ------------------------------------------------------------- properties
    @property
    def num_lines(self) -> int:
        return self._num_lines

    @property
    def num_pipes(self) -> int:
        return len(self._pipes)

    @property
    def num_tokens(self) -> int:
        """Tokens fully admitted so far (monotone across runs)."""
        return self._num_tokens

    @property
    def num_deferrals(self) -> int:
        """Times a line finished a pipe but parked because its next slot was
        still held (full SERIAL stage / wrap not yet released)."""
        return self._num_deferrals.value()

    @property
    def num_token_deferrals(self) -> int:
        """Times a first-pipe body called :meth:`Pipeflow.defer` (including
        deferrals satisfied immediately because the dependency had already
        completed)."""
        return self._num_token_deferrals.value()

    @property
    def num_resumes(self) -> int:
        """Times a deferred token re-ran its first pipe after its dependency
        completed. Once the pipeline has drained this equals
        :attr:`num_token_deferrals` — every deferral resumes exactly once
        (immediately, when the dependency had already completed)."""
        return self._num_resumes.value()

    @property
    def stage_times(self) -> Dict[str, float]:
        """Cumulative wall-clock seconds spent INSIDE each pipe's body,
        summed over lines and runs (keyed by pipe name). Pure
        observability: where a long-running pipeline actually spends its
        time — e.g. the serve engine's admit/prefill/decode/complete
        breakdown the decode-overlap microbench reports. Safe to read
        concurrently (monotone per-slot counters; a mid-stage read is at
        worst one stage-visit stale)."""
        out: Dict[str, float] = {}
        for s, pipe in enumerate(self._pipes):
            ns = sum(self._stage_ns[l][s] for l in range(self._num_lines))
            out[pipe.name] = out.get(pipe.name, 0.0) + ns / 1e9
        return out

    @property
    def taskflow(self) -> Taskflow:
        return self._taskflow

    # ------------------------------------------------------------------ build
    def _build(self) -> None:
        tf = self._taskflow
        L, S = self._num_lines, len(self._pipes)
        grid: List[List[Task]] = [
            [tf.multi_condition(self._make_slot(l, s), name=f"pipe-L{l}S{s}",
                                domain=self._pipes[s].domain)
             for s in range(S)]
            for l in range(L)]
        for l in range(L):
            for s in range(S):
                # successor 0: same line, next pipe (last pipe wraps to re-
                # admit the line); successor 1: next line, same pipe (SERIAL
                # hand-off). Both edges are weak — the grid is one big cycle.
                grid[l][s].precede(grid[l][(s + 1) % S], grid[(l + 1) % L][s])
        start = tf.condition(lambda: self._start_line, name="pipeline-start")
        start.precede(*[grid[l][0] for l in range(L)])
        self._grid = grid

    def _make_slot(self, l: int, s: int) -> Callable[[], tuple]:
        L, S = self._num_lines, len(self._pipes)
        pipe = self._pipes[s]
        serial = pipe.kind is PipeType.SERIAL
        counters = self._counters

        def run_slot() -> tuple:
            pf = self._pipeflows[l]
            pf._pipe = s
            if s == 0:
                # stage 0 is SERIAL: exactly one line here at a time (a
                # parked line HOLDS the stage — admission pauses), so the
                # token counter, stop flag and parked flag need no
                # synchronisation.
                if self._stopped:
                    self._parked[l] = False  # defensive: dropped by a drain
                    return ()
                if self._parked[l]:
                    self._parked[l] = False
                    self._num_resumes.inc()
                pf._token = self._num_tokens
                pf._stopped = False
                pf._defer_on = None
                while True:
                    _t = time.perf_counter_ns()
                    self._invoke(pipe, pf)
                    _t2 = time.perf_counter_ns()
                    self._stage_ns[l][s] += _t2 - _t
                    if self.tracer is not None:
                        self.tracer.add(pipe.name, f"line{l}",
                                        _t / 1e9, _t2 / 1e9)
                    if pf._stopped:
                        self._stopped = True
                        return ()  # break both chains: in-flight drain
                    dep = pf._defer_on
                    if dep is None:
                        break
                    pf._defer_on = None
                    if dep >= self._num_tokens:
                        raise ValueError(
                            f"token {pf._token} deferred on un-minted "
                            f"token {dep}")
                    self._num_token_deferrals.inc()
                    if not self._register_deferral(l, dep):
                        # dependency already completed: satisfied
                        # immediately — re-run the stage body now
                        self._num_resumes.inc()
                        continue
                    # Park: release NOTHING. The token is not minted, the
                    # SERIAL hand-off chain pauses at this line (no token
                    # overtakes — the static grid's round-robin hand-off
                    # protocol requires mint order to follow lines), and
                    # in-flight tokens keep draining their stages. The
                    # dependency's last pipe re-schedules this slot.
                    self._parked[l] = True
                    return ()
                self._num_tokens += 1
            else:
                _t = time.perf_counter_ns()
                self._invoke(pipe, pf)
                _t2 = time.perf_counter_ns()
                self._stage_ns[l][s] += _t2 - _t
                if self.tracer is not None:
                    self.tracer.add(pipe.name, f"line{l}",
                                    _t / 1e9, _t2 / 1e9)
            if s == S - 1:
                # token fully done: wake a deferred token waiting on it.
                # Done BEFORE this task's pending-tally so the topology
                # cannot finalize between the wake and the resume running.
                self._complete_token(pf._token)
            # Re-arm this slot for its next visit BEFORE releasing successors
            # (the successor may wrap around and decrement us again). Steady
            # state: pipe 0 waits on {SERIAL hand-off, line wrap} = 2; other
            # SERIAL pipes on {previous token, line arrival} = 2; PARALLEL
            # pipes only on the line's arrival = 1.
            counters[l][s].set(2 if (s == 0 or serial) else 1)
            rets = []
            if serial and counters[(l + 1) % L][s].dec() == 0:
                rets.append(1)
            if counters[l][(s + 1) % S].dec() == 0:
                rets.append(0)
            else:
                # deferred line: the next slot is still held (full SERIAL
                # stage or un-wrapped line) — park without blocking a worker.
                pf.num_deferrals += 1
                self._num_deferrals.inc()
            return tuple(rets)

        run_slot.__name__ = f"pipe_{pipe.name}_L{l}S{s}"
        return run_slot

    def _invoke(self, pipe: Pipe, pf: Pipeflow) -> None:
        """Stage dispatch; DataPipeline overrides to thread per-line buffers."""
        pipe.fn(pf)

    # ------------------------------------------------- token-level deferral
    def _is_completed(self, token: int) -> bool:
        return token <= self._completed_watermark or \
            token in self._completed_set

    def _register_deferral(self, line: int, dep: int) -> bool:
        """Park ``line`` until ``dep`` completes. False if ``dep`` already
        completed (the deferral is satisfied immediately)."""
        with self._defer_lock:
            if self._is_completed(dep):
                return False
            if self._executor is None:
                raise RuntimeError(
                    "Pipeflow.defer() needs the pipeline to be driven via "
                    "Pipeline.run(executor) so resumes can be scheduled")
            self._deferred_waiters.setdefault(dep, []).append(line)
            return True

    def _complete_token(self, token: int) -> None:
        """Mark ``token`` complete and reschedule any parked first-pipe slots
        that deferred on it (the weak-edge bypass: scheduled directly, join
        counters untouched). Called inside a slot's execution, so the
        topology's pending count cannot reach zero before the resumes land."""
        with self._defer_lock:
            self._completed_set.add(token)
            while self._completed_watermark + 1 in self._completed_set:
                self._completed_watermark += 1
                self._completed_set.discard(self._completed_watermark)
            waiters = self._deferred_waiters.pop(token, ())
        for line in waiters:
            self._executor._schedule(None, self._grid[line][0]._node)

    # -------------------------------------------------------------- execution
    def reset(self) -> None:
        """Re-arm join counters for a fresh run. Must not be called while a
        topology of this pipeline is in flight. Token numbering continues:
        the next token runs on line ``num_tokens % num_lines``."""
        if self._topology is not None and not self._topology.done():
            raise RuntimeError("cannot reset a running pipeline")
        L, S = self._num_lines, len(self._pipes)
        self._stopped = False
        # a drained run has completed (or dropped) every minted token; fold
        # the completion bookkeeping into the watermark and clear parked state
        with self._defer_lock:
            self._completed_watermark = self._num_tokens - 1
            self._completed_set.clear()
            self._deferred_waiters.clear()
        self._parked = [False] * L
        self._start_line = l0 = self._num_tokens % L
        for l in range(L):
            pf = self._pipeflows[l]
            pf._pipe = 0
            pf._stopped = False
            ring = (l - l0) % L  # distance from the starting line
            # first pipe: the start condition schedules line l0 directly
            # (weak-edge bypass); every later line waits on the SERIAL
            # hand-off alone — the wrap dependency cannot fire in round one.
            self._counters[l][0].set(0 if ring == 0 else 1)
            for s in range(1, S):
                if ring == 0:
                    v = 1  # the very first token has no SERIAL predecessor
                else:
                    v = 2 if self._pipes[s].kind is PipeType.SERIAL else 1
                self._counters[l][s].set(v)

    def idle(self) -> bool:
        """True when no topology of this pipeline is in flight — the drained
        state in which :meth:`run` may re-arm it without rebuilding."""
        return self._topology is None or self._topology.done()

    def run(self, executor: Executor,
            on_complete: Optional[Callable[[Topology], None]] = None
            ) -> Topology:
        """Reset and submit one drain-to-completion run of the pipeline.

        The static grid is built once in ``__init__``; ``run`` only re-arms
        join counters (:meth:`reset`) and resubmits — the re-arm-without-
        rebuild path long-running clients (the serve engine, the prefetcher)
        use to keep one resident pipeline alive across drain/refill cycles.
        """
        self.reset()
        self._executor = executor
        self._topology = executor.run(self._taskflow, on_complete)
        return self._topology

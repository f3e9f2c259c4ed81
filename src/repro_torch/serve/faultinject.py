"""Deterministic fault-injection harness for the serve runtime.

The engine's hazard paths — deferred-free fences, CoW guards,
stall-not-preempt, shedding/expiry, watchdog — exist for conditions that
are hard to reach organically in a unit test (pool races, device
exceptions, latency spikes). This module makes them reachable ON DEMAND
and DETERMINISTICALLY: the engine consults a :class:`FaultInjector` at
named sites, and each site fires according to a seeded per-site schedule
that depends only on how many times the site was reached — never on
wall-clock time or interpreter hash state. The same spec + the same
request sequence therefore reproduces the same faults bit-for-bit.

Spec grammar (``REPRO_FAULT_INJECT`` env var or
``ServeEngine(fault_inject=...)``)::

    spec    := clause (';' clause)*
    clause  := site [':' param (',' param)*]
    param   := key '=' value

Sites (where the engine consults the injector):

==================  =====================================================
``alloc_fail``      admission block allocation returns None (the group
                    requeues and retries — benign, exercises the
                    park/evict/requeue path)
``grow_fail``       a mid-decode ``grow_table`` returns None (exercises
                    prefix eviction, stall-not-preempt and the
                    cost-model preemption path — benign: greedy replay
                    is bit-identical)
``chunk_sync_exc``  raises :class:`FaultInjected` at the decode chunk
                    sync point (exercises per-row failure isolation:
                    seated rows fail typed, the engine keeps serving)
``chunk_latency``   sleeps ``ms`` milliseconds at the sync point
                    (exercises the watchdog and SLO expiry under load)
``preempt``         force-preempts one resident row (cost-model victim
                    order — benign replay)
``evict``           force-evicts one parked prefix block (benign)
``crash_at``        hard process death (``os._exit``) at the decode
                    chunk sync point — no cleanup, no atexit, no
                    journal flush beyond what fsync cadence already
                    persisted. The kill-and-recover test uses
                    ``crash_at:at=N`` for a deterministic mid-stream
                    crash (``tests/test_serve_recover.py``)
``snapshot_corrupt``  flips a payload byte in the snapshot file right
                    after ``ServeEngine.snapshot`` writes it —
                    exercises the checksum + typed
                    :class:`~repro_torch.serve.errors.SnapshotCorrupt`
                    cold-start fallback in ``recover()``
==================  =====================================================

Params (one *trigger* per clause — ``p``, ``at`` or ``every``; bare
sites fire on every opportunity):

``p=F``       fire with probability F per opportunity (seeded RNG)
``at=N``      fire exactly on the N-th opportunity (1-based)
``every=N``   fire on every N-th opportunity
``n=N``       cap: stop after N fires (default unlimited; bare-site
              clauses without a trigger default to ``n=1``)
``ms=F``      sleep duration for ``chunk_latency`` (milliseconds)
``seed=N``    per-clause RNG seed for ``p`` (default 0)

Example — the CI chaos leg's low-rate benign spec::

    REPRO_FAULT_INJECT="alloc_fail:p=0.05,seed=11;grow_fail:p=0.05,seed=11"

Opportunity counters are per-injector (one injector per engine), so two
engines with the same spec see identical schedules.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Optional

__all__ = ["FaultInjected", "FaultInjector", "SITES"]

#: Named injection sites the engine consults (see module docstring).
SITES = ("alloc_fail", "grow_fail", "chunk_sync_exc", "chunk_latency",
         "preempt", "evict", "crash_at", "snapshot_corrupt")

_TRIGGERS = ("p", "at", "every")
_KEYS = _TRIGGERS + ("n", "ms", "seed")


class FaultInjected(RuntimeError):
    """Raised by the engine at a ``chunk_sync_exc`` site."""

    def __init__(self, site: str) -> None:
        super().__init__(f"injected fault at site {site!r}")
        self.site = site


class _Rule:
    __slots__ = ("site", "p", "at", "every", "n", "ms", "_rng",
                 "opportunities", "fires")

    def __init__(self, site: str, p: Optional[float], at: Optional[int],
                 every: Optional[int], n: Optional[int], ms: float,
                 seed: int) -> None:
        self.site = site
        self.p = p
        self.at = at
        self.every = every
        self.n = n
        self.ms = ms
        self._rng = random.Random(seed)
        self.opportunities = 0
        self.fires = 0

    def fire(self) -> bool:
        self.opportunities += 1
        if self.n is not None and self.fires >= self.n:
            return False
        if self.at is not None:
            hit = self.opportunities == self.at
        elif self.every is not None:
            hit = self.opportunities % self.every == 0
        elif self.p is not None:
            hit = self._rng.random() < self.p
        else:
            hit = True
        if hit:
            self.fires += 1
        return hit


class FaultInjector:
    """Seeded per-site fault schedule (see module docstring). Thread-safe;
    the engine calls :meth:`fire` at each site opportunity."""

    def __init__(self) -> None:
        self._rules: Dict[str, _Rule] = {}
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str) -> "FaultInjector":
        """Build an injector from the spec grammar; raises ``ValueError``
        on unknown sites/keys, duplicate clauses, or multiple triggers."""
        inj = cls()
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            site, _, rest = clause.partition(":")
            site = site.strip()
            if site not in SITES:
                raise ValueError(
                    f"unknown fault site {site!r} (expected one of {SITES})")
            if site in inj._rules:
                raise ValueError(f"duplicate fault clause for site {site!r}")
            kw: Dict[str, float] = {}
            if rest.strip():
                for param in rest.split(","):
                    key, eq, val = param.partition("=")
                    key = key.strip()
                    if not eq or key not in _KEYS:
                        raise ValueError(
                            f"bad fault param {param!r} for site {site!r} "
                            f"(expected key=value with key in {_KEYS})")
                    kw[key] = float(val)
            triggers = [k for k in _TRIGGERS if k in kw]
            if len(triggers) > 1:
                raise ValueError(
                    f"site {site!r}: at most one trigger of {_TRIGGERS}")
            n = kw.get("n")
            if not triggers and n is None:
                n = 1    # bare site: fire once, not forever
            inj._rules[site] = _Rule(
                site,
                p=kw.get("p"),
                at=int(kw["at"]) if "at" in kw else None,
                every=int(kw["every"]) if "every" in kw else None,
                n=int(n) if n is not None else None,
                ms=kw.get("ms", 0.0),
                seed=int(kw.get("seed", 0)))
        return inj

    def fire(self, site: str) -> bool:
        """One opportunity at ``site``: returns True when the fault should
        trigger now. Sites with no clause never fire (and cost one dict
        probe)."""
        rule = self._rules.get(site)
        if rule is None:
            return False
        with self._lock:
            return rule.fire()

    def latency_s(self, site: str) -> float:
        """Sleep duration (seconds) configured for ``site`` (``ms=`` param)."""
        rule = self._rules.get(site)
        return rule.ms / 1000.0 if rule is not None else 0.0

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per-site ``{opportunities, fires}`` — diagnostics for tests."""
        with self._lock:
            return {s: {"opportunities": r.opportunities, "fires": r.fires}
                    for s, r in self._rules.items()}

"""Request journal: an append-only WAL for the serve engine.

Durability boundary #1 (see ``docs/robustness.md`` "Durability &
recovery"): every request lifecycle transition the engine performs —
``submit`` / ``admit`` / ``first_token`` / ``finish`` / ``cancel`` — is
appended to a checksummed, line-delimited journal file, with the full
prompt token ids recorded at submit. Greedy decode is deterministic, so
the journal alone is enough to recover from a hard crash: on restart,
:func:`replay` classifies every journaled request as *finished* (a
terminal ``finish``/``cancel`` record exists — the client already got
its result, nothing to do) or *incomplete* (no terminal record — the
process died while it was queued or mid-decode), and the engine
re-submits the incomplete ones, which replay **bit-identically** on the
gather oracle.

Record format — one record per line::

    <crc32-hex8> <compact-json>\\n

The CRC covers the JSON bytes. A hard kill can tear the final line
(partial write); replay detects this via the checksum and truncates at
the FIRST bad record — everything before it is trusted, everything at
and after it is dropped and reported (``JournalReplay.dropped``). This
is standard WAL tail-truncation: a dropped ``finish`` record merely
causes a benign bit-identical re-run of an already-answered request,
never a wrong answer.

Write path discipline: records are buffer-written and flushed on every
append; ``fsync`` runs on a configurable cadence (``fsync_every=N``
records; ``1`` = every record = maximal durability, ``0`` = only on
:meth:`Journal.flush`/:meth:`Journal.close`). The ``journal.lag_s``
gauge exposes how long un-fsynced records have been at risk.

Beyond the reference, three changes to when and how bytes reach the file;
the bytes on disk are the same. :meth:`Journal.batch` group-commits the records one
thread appends inside it (one write and one flush when it exits). And the
``admit`` and ``first_token`` records (``DEFERRED_KINDS``), which no
recovery decision reads, are kept in memory (their time taken, their
encoding left to the writer) and go out ahead of the next
write of any thread (a submit, a finish, a cancel, :meth:`write_pending`,
a flush or the close), in append order: the engine makes them in its
admit, prefill and decode stages, where each write would release the GIL
and leave the stage waiting to get it back from the other threads before
it feeds the device. A hard kill can lose them; :func:`replay` classifies
a request by its submit and terminal records alone, so it loses nothing.
And a write is one ``write(2)`` made WITHOUT releasing the GIL (libc's,
through ``ctypes.PyDLL``, where there is one): a thread that releases the
GIL for a write must win it back from the engine's stage and executor
threads, which cost 0.15-0.2 ms a write on the card's host even to tmpfs,
far more than the write itself. The fsync still releases the GIL.

Off by default: an engine without a journal attached takes a single
``is None`` check per transition — the no-journal path is bit-exact
unchanged.
"""
from __future__ import annotations

import contextlib
import ctypes
import errno
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

__all__ = ["Journal", "JournalReplay", "replay",
           "TERMINAL_KINDS", "RECORD_KINDS", "DEFERRED_KINDS"]

#: Lifecycle transitions the engine journals.
RECORD_KINDS = ("submit", "admit", "first_token", "finish", "cancel")

#: Kinds that mark a request as settled (never replayed).
TERMINAL_KINDS = ("finish", "cancel")

#: Kinds kept in memory until the next write (no recovery decision reads
#: them; see the module docstring).
DEFERRED_KINDS = ("admit", "first_token")


def _libc_write():
    """libc's ``write``, called with the GIL held; None where there is no
    such symbol (writes then go through ``os.write``, which releases it)."""
    try:
        fn = ctypes.PyDLL(None, use_errno=True).write
    except (OSError, AttributeError):
        return None
    fn.argtypes = (ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t)
    fn.restype = ctypes.c_ssize_t
    return fn


#: the write that keeps the GIL (see the module docstring)
GIL_HELD_WRITE = _libc_write()


def _encode(rec: Dict[str, Any]) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"),
                         sort_keys=True).encode("utf-8")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return b"%08x %s\n" % (crc, payload)


def _decode(line: bytes) -> Optional[Dict[str, Any]]:
    """Parse one journal line; None when torn/corrupt."""
    line = line.rstrip(b"\n")
    if len(line) < 10 or line[8:9] != b" ":
        return None
    try:
        crc = int(line[:8], 16)
    except ValueError:
        return None
    payload = line[9:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        return None
    try:
        rec = json.loads(payload)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) and "k" in rec else None


class Journal:
    """Append-only, checksummed request WAL (see module docstring).

    Thread-safe: ``submit`` runs on client threads while ``finish`` runs
    on the engine's complete stage. One lock per append — journal
    records are per *request transition*, not per token, so this is far
    off the decode hot path (the ``journal_gate`` benchmark enforces
    the overhead budget).
    """

    def __init__(self, path: str, *, fsync_every: int = 1) -> None:
        if fsync_every < 0:
            raise ValueError("fsync_every must be >= 0")
        self.path = str(path)
        self.fsync_every = fsync_every
        self._lock = threading.Lock()
        self._f = open(self.path, "ab", buffering=0)
        self._since_sync = 0
        self._dirty_at: Optional[float] = None
        self._lag_gauge = None
        self._rec_counter = None
        self.records_written = 0
        self._batch = threading.local()   # .recs: a batch open on a thread
        # DEFERRED_KINDS records, not yet encoded nor written
        self._pending: List[Dict[str, Any]] = []

    def set_metrics(self, metrics: Any) -> None:
        """Bind ``journal.lag_s`` / ``journal.records`` to a registry."""
        if metrics is None:
            self._lag_gauge = self._rec_counter = None
            return
        self._lag_gauge = metrics.gauge("journal.lag_s")
        self._rec_counter = metrics.counter("journal.records")

    @property
    def lag_s(self) -> float:
        """Seconds the oldest un-fsynced record has been at risk."""
        with self._lock:
            return 0.0 if self._dirty_at is None \
                else time.monotonic() - self._dirty_at

    def append(self, kind: str, **fields: Any) -> None:
        rec = {"k": kind, "t": round(time.time(), 6)}
        rec.update(fields)
        if kind in DEFERRED_KINDS:
            with self._lock:
                self._pending.append(rec)
                if self._dirty_at is None:
                    self._dirty_at = time.monotonic()
            return
        data = _encode(rec)
        recs = getattr(self._batch, "recs", None)
        if recs is not None:
            recs.append(data)
            return
        self._write(data, 1)

    def write_pending(self) -> None:
        """Write the deferred records (a no-op when there are none)."""
        self._write(b"", 0)

    @contextlib.contextmanager
    def batch(self):
        """Keep this thread's appends inside the block and write them with
        one write and one flush when it exits (also on an exception).
        Nested blocks join the outer one."""
        if getattr(self._batch, "recs", None) is not None:
            yield
            return
        self._batch.recs = []
        try:
            yield
        finally:
            recs, self._batch.recs = self._batch.recs, None
            if recs:
                self._write(b"".join(recs), len(recs))

    def _write(self, data: bytes, n: int) -> None:
        with self._lock:
            n = self._write_locked(data, n)
            if n and self.fsync_every \
                    and self._since_sync >= self.fsync_every:
                self._fsync_locked()
        if not n:
            return
        if self._rec_counter is not None:
            self._rec_counter.inc(n)
        if self._lag_gauge is not None:
            self._lag_gauge.set(self.lag_s)

    def _write_locked(self, data: bytes, n: int) -> int:
        """Write the deferred records and then ``data`` (``n`` records) in
        one write and one flush; returns the records written."""
        if self._f.closed:
            return 0
        if self._pending:
            data = b"".join(map(_encode, self._pending)) + data
            n += len(self._pending)
            self._pending.clear()
        if not n:
            return 0
        self._emit(data)
        self.records_written += n
        self._since_sync += n
        if self._dirty_at is None:
            self._dirty_at = time.monotonic()
        return n

    def _emit(self, data: bytes) -> None:
        """Append ``data`` (a second write(2) only for what a short write
        left)."""
        fd = self._f.fileno()
        while data:
            write = GIL_HELD_WRITE
            if write is None:
                n = os.write(fd, data)
            else:
                n = write(fd, data, len(data))
                if n < 0:
                    err = ctypes.get_errno()
                    if err == errno.EINTR:
                        continue
                    raise OSError(err, os.strerror(err), self.path)
            data = data[n:]

    def _fsync_locked(self) -> None:
        os.fsync(self._f.fileno())
        self._since_sync = 0
        self._dirty_at = None

    # -- engine-facing transition helpers ---------------------------------
    def submit(self, req: Any) -> None:
        self.append("submit", id=req.id,
                    prompt=[int(t) for t in req.prompt],
                    max_new=int(req.max_new), priority=int(req.priority),
                    deadline_s=req.deadline_s)

    def admit(self, req: Any) -> None:
        self.append("admit", id=req.id)

    def first_token(self, req: Any) -> None:
        self.append("first_token", id=req.id)

    def finish(self, req: Any, tokens: Any) -> None:
        toks = [int(t) for t in tokens]
        crc = zlib.crc32(json.dumps(toks).encode()) & 0xFFFFFFFF
        self.append("finish", id=req.id, n=len(toks), crc=crc)

    def cancel(self, req: Any, kind: str) -> None:
        """Terminal non-finish record (cancelled / expired / shed)."""
        self.append("cancel", id=req.id, why=kind)

    # ---------------------------------------------------------------------
    def flush(self) -> None:
        """Flush and fsync everything appended so far."""
        with self._lock:
            if self._f.closed:
                return
            n = self._write_locked(b"", 0)
            self._fsync_locked()
        if n and self._rec_counter is not None:
            self._rec_counter.inc(n)
        if self._lag_gauge is not None:
            self._lag_gauge.set(0.0)

    def close(self) -> None:
        with self._lock:
            if self._f.closed:
                return
            self._write_locked(b"", 0)
            self._fsync_locked()
            self._f.close()

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class JournalReplay:
    """Classification of a journal file (see :func:`replay`).

    ``incomplete`` preserves journal order, so re-submission reproduces
    the original arrival order (admission order under load may still
    differ — bit-identity is per-request, guaranteed by greedy decode).
    """

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self.submits: Dict[int, Dict[str, Any]] = {}
        self.terminal: Dict[int, str] = {}
        self.finished: Dict[int, Dict[str, Any]] = {}
        self.dropped = 0          # corrupt/torn lines truncated at tail

    @property
    def incomplete(self) -> List[Dict[str, Any]]:
        return [rec for rid, rec in self.submits.items()
                if rid not in self.terminal]

    @property
    def replayed_tokens(self) -> int:
        return sum(len(r["prompt"]) for r in self.incomplete)


def replay(path: str) -> JournalReplay:
    """Read a journal, truncating at the first torn/corrupt record."""
    rep = JournalReplay()
    if not os.path.exists(path):
        return rep
    with open(path, "rb") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        rec = _decode(line)
        if rec is None:
            rep.dropped = len(lines) - i
            break
        rep.records.append(rec)
        kind = rec["k"]
        rid = rec.get("id")
        if kind == "submit" and rid is not None:
            rep.submits[rid] = rec
        elif kind in TERMINAL_KINDS and rid is not None:
            rep.terminal[rid] = kind
            if kind == "finish":
                rep.finished[rid] = rec
    return rep

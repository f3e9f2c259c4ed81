"""Where the journaled serve path spends its time, on the journal gate's
workload (:mod:`repro_torch.bench.journal_gate`).

Runs :func:`journal_gate.measure` once per variant, in this order:

* ``shipped`` — the engine and journal as they are;
* ``A/A`` — the "on" repetitions attach no journal: the gate's own bias
  and spread, with both modes the same;
* ``written in the stages`` — no record kind is deferred
  (``DEFERRED_KINDS = ()``), so the admit, prefill and decode stages write
  their admit and first-token records themselves;
* ``no submit wait`` — the idle engine's admit stage does not wait for
  submits in progress (``SUBMIT_WAIT_S = 0``), so a journaled burst is
  admitted as it trickles in;
* ``one write per record`` — ``Journal.batch`` is a null context and no
  kind is deferred, so every record is its own write and flush where it
  is made (the reference's write path);
* ``submits deferred`` — a diagnostic that gives up the submit's
  durability: the submit records wait in memory like the admit and
  first-token ones, so the client's thread makes no write;
* ``complete stage writes nothing`` — a diagnostic: the finish records are
  dropped and the deferred records wait for the next submit;
* ``write releases the GIL`` — the journal writes with ``os.write``
  (``GIL_HELD_WRITE = None``), which releases the GIL for the system call;
* ``no write syscall`` — the journal writes nothing: encoding and locking
  only, nothing durable (the floor of the journal's cost);
* ``journal on /dev/shm`` — a diagnostic: the gate's journals live in
  memory (tmpfs) instead of the temporary directory, which sets apart the
  cost of the filesystem a write goes to.

Each prints the gate's on/off ratio (the median of the per-pair ratios)
with the quartiles of the per-pair ratios and the medians of the pairs
run off/on and on/off apart, each mode's prefill groups and the
milliseconds a repetition spends in ``Journal.append`` by record kind, in
``Journal._write`` and ``Journal._emit`` (the write; ``_emit first``: each
journal's first, to a new file), and in the
garbage collector by generation and mode (``gc2 on``: full collections
during journaled repetitions), with the count of full collections. Only
the probe's own process is patched.

    python -m repro_torch.bench.journal_probe [--full] [--device cpu]
        [--variants shipped,A/A,...]
"""
from __future__ import annotations

import contextlib
import gc
import tempfile
import time

import numpy as np


@contextlib.contextmanager
def _variant(name: str, spent: dict):
    from ..serve import engine as emod
    from ..serve import journal as jmod

    J, E = jmod.Journal, emod.ServeEngine
    patched = [(emod, "SUBMIT_WAIT_S"), (jmod, "DEFERRED_KINDS"),
               (jmod, "GIL_HELD_WRITE"),
               (J, "append"), (J, "_write"), (J, "batch"), (J, "_emit"),
               (J, "_fsync_locked"), (J, "finish"), (J, "write_pending"),
               (E, "set_journal")]
    saved = [getattr(o, a) for o, a in patched]

    def timed(fn, key):
        def run(self, *a, **k):
            t = time.perf_counter()
            fn(self, *a, **k)
            k2 = a[0] if key is None else key
            spent[k2] = spent.get(k2, 0.0) + time.perf_counter() - t
        return run

    J.append = timed(J.append, None)
    J._write = timed(J._write, "_write")
    emit = J._emit

    def emit_timed(self, data):
        # a journal's first write (a new file) apart from the rest
        k = "_emit first" if self.records_written == 0 else "_emit"
        t = time.perf_counter()
        emit(self, data)
        spent[k] = spent.get(k, 0.0) + time.perf_counter() - t
    J._emit = emit_timed
    # the mode of the repetition in progress, for the collector's account
    on = [False]
    set_journal = E.set_journal

    def tracking(self, j):
        on[0] = j is not None
        set_journal(self, j)
    E.set_journal = tracking
    t_gc = [0.0]

    def collector(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
            return
        k = f"gc{info['generation']} {'on' if on[0] else 'off'}"
        spent[k] = spent.get(k, 0.0) + time.perf_counter() - t_gc[0]
        if info["generation"] == 2:
            spent["full collections"] = spent.get("full collections", 0) + 1
    gc.callbacks.append(collector)
    tmpdir = tempfile.tempdir
    if name == "A/A":
        E.set_journal = lambda self, j: tracking(self, None)
    elif name == "written in the stages":
        jmod.DEFERRED_KINDS = ()
    elif name == "no submit wait":
        emod.SUBMIT_WAIT_S = 0.0
    elif name == "one write per record":
        J.batch = lambda self: contextlib.nullcontext()
        jmod.DEFERRED_KINDS = ()
    elif name == "submits deferred":
        jmod.DEFERRED_KINDS = jmod.DEFERRED_KINDS + ("submit",)
    elif name == "complete stage writes nothing":
        J.finish = lambda self, req, tokens: None
        J.write_pending = lambda self: None
    elif name == "write releases the GIL":
        jmod.GIL_HELD_WRITE = None
    elif name == "no write syscall":
        J._emit = lambda self, data: None
        J._fsync_locked = lambda self: setattr(self, "_since_sync", 0)
    elif name == "journal on /dev/shm":
        tempfile.tempdir = "/dev/shm"
    try:
        yield
    finally:
        for (o, a), v in zip(patched, saved):
            setattr(o, a, v)
        gc.callbacks.remove(collector)
        tempfile.tempdir = tmpdir


VARIANTS = ("shipped", "A/A", "written in the stages", "no submit wait",
            "one write per record", "submits deferred",
            "complete stage writes nothing", "write releases the GIL",
            "no write syscall",
            "journal on /dev/shm")


def probe(quick: bool = True, device=None, variants=VARIANTS):
    """Yields (variant, the gate's measurement, ms a repetition by key;
    the count of full collections as it is)."""
    from . import journal_gate

    for name in variants:
        if name not in VARIANTS:
            raise ValueError(f"unknown variant {name!r}; one of {VARIANTS}")
        spent: dict = {}
        with _variant(name, spent):
            r = journal_gate.measure(quick=quick, device=device)
        yield name, r, {k: v if k == "full collections"
                        else v * 1e3 / r["reps"] for k, v in spent.items()}


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the gate's full size (default: --quick's)")
    ap.add_argument("--device", default=None,
                    help="default: CUDA (raises without it)")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated, from: " + ", ".join(VARIANTS))
    args = ap.parse_args(argv)
    for name, r, ms in probe(not args.full, args.device,
                             args.variants.split(",")):
        groups = {m: sorted(set(r["prefills"][m])) for m in ("off", "on")}
        pairs = np.asarray(r["samples"]["on"]) / np.asarray(
            r["samples"]["off"])
        q = np.percentile(pairs, [25, 50, 75]).round(4).tolist()
        print(f"[journal_probe] {name}: on/off {r['ratio']:.4f} (median of "
              f"{r['reps']} pairs; quartiles {q}; off/on pairs "
              f"{np.median(pairs[0::2]):.4f}, on/off pairs "
              f"{np.median(pairs[1::2]):.4f}; medians off {r['off']:.1f}, "
              f"on {r['on']:.1f} tok/s); prefill groups {groups}; ms a "
              f"repetition {({k: round(v, 3) for k, v in ms.items()})}",
              flush=True)


if __name__ == "__main__":
    main()

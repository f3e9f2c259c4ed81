"""Serve cells: the program's engine (``repro_torch.serve.engine.
ServeEngine``, through ``submit`` and ``result`` alone) under open-loop
traffic.

Set-up makes the weights on the device from the seed, builds the engine
with the deployment's settings from the cell's file (rows, KV pool bytes,
maximum context; every other knob at the program's default), sends the
warm-up requests, and starts the arrivals: the ramp's requests, then the
window's. The window opens ``ramp_s`` after the first arrival, when the
resident rows have filled, and lasts ``--seconds``. Each request is timed
from when it was due, not from when it was sent. After the window the
arrivals go on (the ``after`` phase) until every request due in the window
has finished, or ``grace_s`` past the close; then the rest are cancelled
and the engine closed. ``--trace 1`` attaches the engine's observability
(its histograms are zeroed when the window opens) and traces the device
over the last ``trace_s`` seconds of the window (the profiler's stop,
which takes a while, falls after the window's arrivals).

Then the program's state is freed and the sampled answers are held
against the plain reference (``perfbench/correct.py``).
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from perfbench import correct, port, weights
from perfbench.harness import log


@dataclass
class Request:
    """One request as the harness saw it (perf_counter times)."""
    phase: str
    due: float
    prompt: np.ndarray
    max_new: int
    handle: Any = None
    error: Optional[str] = None     # refused, failed by the engine, bad
    late: bool = False              # unfinished when the grace ran out
    tokens: Optional[np.ndarray] = None
    admitted: Optional[float] = None
    first: Optional[float] = None
    finish: Optional[float] = None
    ok: bool = False

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def n_out(self) -> int:
        return 0 if self.tokens is None else int(self.tokens.shape[0])


def engine_kwargs(spec, ref) -> dict:
    from repro_torch.serve.engine import ServeEngine
    e = spec.cell["engine"]
    kw = {"max_batch": int(e["max_batch"]),
          "max_seq_len": int(e["max_context"])}
    per_token = ref.kv_bytes_per_token(spec.conf)
    if per_token is not None:
        bs = inspect.signature(ServeEngine.__init__).parameters[
            "block_size"].default
        kw["kv_blocks"] = int(e["kv_pool_bytes"]) // (bs * per_token)
    return kw


def _warm(eng, spec, vocab: int, paged: bool) -> None:
    """The prefill shapes the mix reaches: prompts of the shortest length,
    doubling up to twice the engine's prefill window (its first window's
    shapes and one streamed window), or the shortest and the longest
    prompt on the slot path; one at a time, each with the shortest
    output."""
    p, o = spec.mix["prompt_len"], spec.mix["output_len"]
    if paged:
        lens, n = [], p["min"]
        while n <= min(p["max"], 2 * eng.prefill_chunk):
            lens.append(n)
            n *= 2
    else:
        lens = [p["min"], p["max"]]
    for n in lens:
        prompt = (np.arange(n) * 7919 % vocab).astype(np.int32)
        eng.result(eng.submit(prompt, o["min"]), timeout=600)


def setup(r) -> dict:
    """Weights, the engine and its warm-up: what a run's windows share."""
    spec, dev = r.spec, r.device
    ref = spec.reference()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    V = spec.conf["vocab_size"]
    pcfg = port.config(spec)
    flat = weights.make(ref.shapes(spec.conf), r.seed, dev, served=True,
                        vocab=V)
    log(f"set-up: weights made at {time.perf_counter() - r.t_start:.3f} s")
    from repro_torch.serve.engine import ServeEngine
    obs = None
    if r.trace:
        from repro_torch.obs import Observability
        obs = Observability()
    eng = ServeEngine(pcfg, weights.tree(flat), obs=obs, device=dev,
                      **engine_kwargs(spec, ref))
    log(f"set-up: engine built at {time.perf_counter() - r.t_start:.3f} s")
    ctx = {"eng": eng, "flat": flat, "obs": obs, "ref": ref, "vocab": V}
    try:
        _warm(eng, spec, V, eng.paged)
    except BaseException:
        eng.close(timeout=30)
        raise
    log(f"set-up: warm at {time.perf_counter() - r.t_start:.3f} s")
    return ctx


def measure(r, ctx) -> None:
    """One window of the cell's traffic on the built engine: arrivals,
    the window, the requests' collection. Leaves the engine idle."""
    eng, obs, V = ctx["eng"], ctx["obs"], ctx["vocab"]
    traffic = r.spec.generator().requests(r.spec.mix, r.spec.cell, V,
                                          r.seed, r.seconds)
    prof = None
    if r.trace and r.device.type == "cuda":
        from perfbench.trace import Profile
        Profile.warm(r.device)
        prof = Profile(r.device)
    reqs = _drive(r, eng, traffic, prof, obs)
    late = [q for q in reqs if q.handle is not None and not q.handle.done()]
    for q in late:
        q.late = True
        q.handle.cancel()
    deadline = time.perf_counter() + 120
    while any(not q.handle.done() for q in late) and \
            time.perf_counter() < deadline:
        time.sleep(0.01)
    _collect(r, reqs, V)
    if obs is not None:
        r.tracer = obs.tracer


def teardown(r, ctx) -> None:
    """Close the engine, read the peak memory, free the program's state."""
    eng = ctx.pop("eng")
    eng.close(timeout=120)
    r.notes.append(f"engine stats: {eng.stats}")
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)
    del eng
    if r.device.type == "cuda":
        torch.cuda.empty_cache()


def run(r) -> None:
    ctx = setup(r)
    try:
        measure(r, ctx)
    finally:
        teardown(r, ctx)
    correct.serve(r, ctx["ref"], ctx["flat"])


def _drive(r, eng, traffic, prof, obs):
    """Send every request at its due time until the window's have all
    finished (or the grace has passed); returns the requests."""
    mix = r.spec.mix
    t_base = time.perf_counter() + 0.01
    w0 = t_base + r.spec.generator().ramp_s(mix, r.spec.cell)
    w1 = w0 + r.seconds
    a = w1 - min(float(r.seconds), float(mix["trace_s"]))
    grace = float(r.spec.cell["grace_s"])
    r.window, r.setup_s = (w0, w1), w0 - r.t_start
    reqs = [Request(q["phase"], t_base + q["due"], q["prompt"], q["max_new"])
            for q in traffic]
    window = [q for q in reqs if q.phase == "window"]
    i, late, zeroed, traced = 0, 0.0, obs is None, 0 if prof else 2
    closed = False
    while True:
        now = time.perf_counter()
        if not zeroed and now >= w0:
            obs.metrics.reset()
            zeroed = True
        if traced == 0 and now >= a:
            prof.start()
            traced = 1
        while i < len(reqs) and reqs[i].due <= now:
            q = reqs[i]
            late = max(late, time.perf_counter() - q.due)
            try:
                q.handle = eng.submit(q.prompt, q.max_new)
            except Exception as e:          # refused: a miss
                q.error = repr(e)
            i += 1
        if now >= w1 and not closed:
            closed = True
            r.obs = _histograms(obs)
            if traced == 1:
                prof.stop()
                traced = 2
        if closed:
            pending = [q for q in window if q.handle is not None
                       and not q.handle.done()]
            if not pending or now > w1 + grace:
                break
        nxt = min([t for t in ((reqs[i].due if i < len(reqs) else None),
                               a if traced == 0 else None,
                               w1 if not closed else None,
                               w0 if not zeroed else None)
                   if t is not None] + [now + 0.005])
        time.sleep(max(0.0, nxt - time.perf_counter()))
    r.profile = prof
    r.notes.append(f"arrivals: {i} of {len(reqs)} sent; the generator ran "
                   f"at most {late * 1e3:.3f} ms late")
    return reqs


def _histograms(obs):
    """The engine's histograms as the window closed: the window's own
    admissions and cycles (they were zeroed when it opened)."""
    if obs is None:
        return None
    from repro_torch.obs import Histogram
    out = {}
    for name in obs.metrics.names():
        h = obs.metrics.get(name)
        if isinstance(h, Histogram) and h.count:
            out[name] = {"count": h.count, "mean": h.summary()["mean"],
                         "p95": h.percentile(95.0)}
    return out


def _collect(r, reqs, vocab: int) -> None:
    for q in reqs:
        h = q.handle
        if h is None:
            continue
        q.admitted, q.first, q.finish = (h.admitted_at, h.first_token_at,
                                         h.finished_at)
        if q.late:
            continue
        try:
            q.tokens = np.asarray(h.result(timeout=0))
        except Exception as e:
            q.error = repr(e)
            continue
        q.ok = (q.n_out == q.max_new and q.first is not None
                and q.finish is not None and bool(
                    ((q.tokens >= 0) & (q.tokens < vocab)).all()))
        if not q.ok:
            q.error = q.error or "malformed answer"
    window = [q for q in reqs if q.phase == "window"]
    r.requests = reqs
    r.attempted = len(window)
    r.failed = sum(not q.ok for q in window)
    if r.failed:
        kinds = {}
        for q in window:
            if not q.ok:
                k = "unfinished at the grace's end" if q.late else q.error
                kinds[k] = kinds.get(k, 0) + 1
        log(f"window requests not served: {kinds}")

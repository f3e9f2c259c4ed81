"""The conditional task graphs that hold ``CondGraph`` to its plain version.

:func:`programs` builds the scenarios of ``tests/test_jaxgraph.py`` (a DAG,
a do-while cycle, branching conditions, a merged superblock, an
out-of-range index, a ``max_iters`` bound) and the graph whose entry task
was not added first, on any graph class with the ``JaxGraph`` API: the CPU
tests build them on ``repro.core.JaxGraph`` with ``jax.numpy`` ops and on
:class:`repro_torch.core.CondGraph` with torch ops, from the same
definitions. :func:`check_device` compiles each of them on the card, with
a bounded fig17 loop (x at unit spectral norm, ``x @ x * 0.5``, k = 256)
and a data-dependent loop that stops on a device-side test, and fails
unless every compiled program:

* equals ``lower()`` run on the card and on the CPU (exact for integer
  leaves; rel <= 1e-5 for fp32, where the card's matmul sums in another
  order than the CPU's);
* makes exactly one graph launch per call, and runs under
  ``torch.cuda.set_sync_debug_mode("error")``;
* is right again on a second call with re-bound state.

``chip_smoke.py`` (phase ``condgraph``) and
``tests/test_torch_condgraph_gpu.py`` run it on the card.

:func:`nested_flow` records a DeviceFlow that nests a conditional program
(the data-dependent loop) between two ops of its own, in either
framework; :func:`check_nested` holds the card's flow, which nests the
compiled program, to the same ops around ``lower()`` run eagerly
(``chip_smoke.py`` phase ``nested``, ``tests/test_torch_deviceflow_gpu.py``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["TorchOps", "programs", "check_device", "FP_REL_TOL",
           "fig17_state", "fig17_graph", "until_small_graph",
           "until_small_state", "nested_flow", "check_nested"]

#: fp32 leaves: compiled program against ``lower()`` (card and CPU)
FP_REL_TOL = 1e-5


class TorchOps:
    """The ops a program needs, on torch tensors of one device."""

    def __init__(self, device: Any = "cpu") -> None:
        from repro_torch.core import STOP, CondGraph
        self.G, self.STOP = CondGraph, STOP
        self.device = torch.device(device)
        self.where = torch.where

    def i32(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32, device=self.device)

    def f32(self, v) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)


class Program(NamedTuple):
    graph: Any
    state: Dict[str, Any]
    kw: Dict[str, Any]           # lower()/compile() keywords
    expect: Dict[str, float]     # leaves the reference's test asserts


def programs(ops) -> Dict[str, Program]:
    """The scenarios, built with ``ops`` (``G``, ``STOP``, ``where``,
    ``i32``, ``f32``)."""
    G, STOP, where = ops.G, ops.STOP, ops.where

    def state(**kw):
        base = {"i": ops.i32(0), "x": ops.f32(1.0)}
        base.update(kw)
        return base

    out = {}
    g = G()
    a = g.task(lambda s: {**s, "x": s["x"] + 1})
    b = g.task(lambda s: {**s, "x": s["x"] * 3})
    a.precede(b)
    out["dag"] = Program(g, state(), {}, {"x": 6.0})

    g = G()
    stepn = g.task(lambda s: {"i": s["i"] + 1, "x": s["x"] * 2})
    chk = g.cond(lambda s: (where(s["i"] >= 6, 1, 0), s))
    stepn.precede(chk)
    chk.precede(stepn, STOP)
    out["do_while"] = Program(g, state(), {}, {"i": 6, "x": 64.0})

    g = G()
    init = g.task(lambda s: {**s, "i": s["i"] * 0})

    def coin(s):
        s = {**s, "i": s["i"] + 1}
        return where(s["i"] == 2, 0, 1), s

    f1, f2, f3 = g.cond(coin), g.cond(coin), g.cond(coin)
    init.precede(f1)
    f1.precede(f1, f2)
    f2.precede(f1, f3)
    f3.precede(f1, STOP)
    out["branching"] = Program(g, state(), {}, {"i": 5})

    g = G()
    ts = [g.task(lambda s, k=k: {**s, "i": s["i"] + k}) for k in range(5)]
    for t0, t1 in zip(ts, ts[1:]):
        t0.precede(t1)
    c = g.cond(lambda s: (where(s["i"] > 100, 1, 0), s))
    ts[-1].precede(c)
    c.precede(ts[0], STOP)
    out["superblock"] = Program(g, state(), {}, {"i": 110})

    g = G()
    c = g.cond(lambda s: (ops.i32(7), s))
    t = g.task(lambda s: {**s, "i": s["i"] + 100})
    c.precede(t)
    out["out_of_range"] = Program(g, state(), {}, {"i": 0})

    g = G()
    stepn = g.task(lambda s: {**s, "i": s["i"] + 1})
    c = g.cond(lambda s: (ops.i32(0), s))     # loops forever
    stepn.precede(c)
    c.precede(stepn, STOP)
    out["max_iters"] = Program(g, state(), {"max_iters": 10}, {"i": 10})

    # the entry task is added second: it runs first under Taskflow's
    # semantics (122); a machine that starts at block 0 skips it (222)
    g = G()
    x = g.task(lambda s: {**s, "i": s["i"] + 100}, name="x")
    e = g.task(lambda s: {**s, "i": s["i"] - 100}, name="entry")
    c = g.cond(lambda s: (where(s["i"] > 100, 1, 0), s), name="c")
    e.precede(c)
    c.precede(x, STOP)
    x.precede(c)
    out["entry_block"] = Program(g, state(i=ops.i32(122)), {}, {"i": 122})
    return out


def fig17_graph(G, STOP, where, k: int = 256):
    """fig17's loop: ``x <- x @ x * 0.5`` k times (the reference's
    ``benchmarks/fig17_conditional_memory.py`` program)."""
    g = G()
    stp = g.task(lambda s: {"i": s["i"] + 1, "x": s["x"] @ s["x"] * 0.5},
                 name="step")
    cnd = g.cond(lambda s: (where(s["i"] >= k, 1, 0), s), name="done?")
    stp.precede(cnd)
    cnd.precede(stp, STOP)
    return g


def fig17_state(n: int = 256, device: Any = "cpu", bounded: bool = False,
                seed: int = 0) -> Dict[str, torch.Tensor]:
    """fig17's state: ``x`` all ones (the reference's, which overflows to
    inf) or, ``bounded``, seeded normal values scaled to unit spectral norm
    (every iterate stays finite)."""
    if bounded:
        x = np.random.default_rng(seed).standard_normal((n, n))
        x = (x / np.linalg.norm(x, 2)).astype(np.float32)
    else:
        x = np.ones((n, n), np.float32)
    return {"i": torch.tensor(0, dtype=torch.int32, device=device),
            "x": torch.from_numpy(x).to(device)}


def until_small_graph(G, STOP, tol: float = 1e-3, where=None, norm=None):
    """A data-dependent loop: ``x <- m @ x`` until ``|x| < tol``, counting
    the steps in ``n``; the test runs on the device. ``where``/``norm``
    are the framework's (default torch's)."""
    where = where or torch.where
    norm = norm or torch.linalg.vector_norm
    g = G()
    step = g.task(lambda s: {**s, "x": s["m"] @ s["x"], "n": s["n"] + 1},
                  name="step")
    small = g.cond(lambda s: (where(norm(s["x"]) < tol, 1, 0), s),
                   name="small?")
    step.precede(small)
    small.precede(step, STOP)
    return g


def until_small_state(d: int = 64, device: Any = "cpu", seed: int = 0,
                      norm: float = 0.9) -> Dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((d, d))
    m = (m * norm / np.linalg.norm(m, 2)).astype(np.float32)
    x = rng.standard_normal(d).astype(np.float32)
    return {"m": torch.from_numpy(m).to(device),
            "x": torch.from_numpy(x).to(device),
            "n": torch.tensor(0, dtype=torch.int32, device=device)}


def _to(state: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in state.items()}


def _rebind(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Other values of the same shapes and dtypes: floats scaled by 0.5."""
    return {k: v * 0.5 if v.is_floating_point() else v.clone()
            for k, v in state.items()}


def _err(got, ref) -> float:
    """Largest error over the leaves: absolute for integers (which must be
    exact), relative to the leaf's largest magnitude for floats."""
    worst = 0.0
    for k in ref:
        a, b = got[k].detach().cpu(), ref[k].detach().cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"leaf {k}: {a.shape} {a.dtype} against "
                                 f"{b.shape} {b.dtype}")
        if not b.is_floating_point():
            worst = max(worst, float((a.long() - b.long()).abs().max()))
            continue
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            return float("inf")
        fin = torch.isfinite(b)
        scale = max(float(b[fin].abs().max()) if fin.any() else 0.0, 1e-30)
        d = (a[fin] - b[fin]).abs()
        worst = max(worst, float(d.max()) / scale if d.numel() else 0.0)
    return worst


def check_device(dev: torch.device, k: int = 256, n: int = 256,
                 log: Optional[Callable[[str], None]] = None) -> dict:
    """Compile every program on ``dev`` and hold it to ``lower()`` on the
    card and on the CPU; raise ``AssertionError`` on the first failure.
    Returns ``{"programs": {name: {...}}, "max_abs_err": worst error,
    "launches": graph launches made}``."""
    from repro_torch.core import STOP, CondGraph
    from repro_torch.kernels import cond_graph

    log = log or (lambda s: None)
    cases = {}
    for name, p in programs(TorchOps("cpu")).items():
        cases[name] = (p.graph, p.state, p.kw, p.expect)
    cases["fig17_bounded"] = (fig17_graph(CondGraph, STOP, torch.where, k),
                              fig17_state(n, bounded=True), {}, {"i": k})
    cases["until_small"] = (until_small_graph(CondGraph, STOP),
                            until_small_state(), {}, {})
    report: dict = {"programs": {}, "max_abs_err": 0.0, "launches": 0}
    for name, (g, st_cpu, kw, expect) in cases.items():
        plain = g.lower(**kw)
        st_dev = _to(st_cpu, dev)
        prog = g.compile(st_dev, **kw)
        row = {"nodes": prog.nodes() if hasattr(prog, "nodes") else None}
        for call, st in (("first", st_dev), ("rebound", _rebind(st_dev))):
            want_cpu = plain(_to(st, "cpu"))
            want_dev = plain(st)
            before, own = cond_graph.launches, prog.num_launches
            torch.cuda.synchronize(dev)
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = prog(st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize(dev)
            wgraph = cond_graph.launches - before
            want = 0 if row["nodes"] is None else 1    # a DAG: torch replay
            if prog.num_launches - own != 1 or wgraph != want:
                raise AssertionError(
                    f"condgraph {name}: {prog.num_launches - own} program "
                    f"launches and {wgraph} WHILE-program launches in one "
                    "call (expected exactly one)")
            report["launches"] += 1
            e_dev, e_cpu = _err(got, want_dev), _err(got, want_cpu)
            row[f"{call}_err_dev"], row[f"{call}_err_cpu"] = e_dev, e_cpu
            report["max_abs_err"] = max(report["max_abs_err"], e_dev, e_cpu)
            tol = FP_REL_TOL
            if not (e_dev <= tol and e_cpu <= tol):
                raise AssertionError(
                    f"condgraph {name} ({call} call): error {e_dev:.3g} "
                    f"against lower() on the card, {e_cpu:.3g} on the CPU "
                    f"(tolerance {tol:g}; integer leaves exact)")
            if call == "first":
                for leaf, v in expect.items():
                    if float(got[leaf]) != v:
                        raise AssertionError(
                            f"condgraph {name}: {leaf}={float(got[leaf])}, "
                            f"expected {v}")
        if name == "until_small":
            row["steps"] = int(got["n"])
        report["programs"][name] = row
        log(f"[condgraph] {name}: nodes {row['nodes']}, error against "
            f"lower() card/CPU {row['first_err_dev']:.3g}/"
            f"{row['first_err_cpu']:.3g} (re-bound "
            f"{row['rebound_err_dev']:.3g}/{row['rebound_err_cpu']:.3g})"
            + (f", {row['steps']} steps" if "steps" in row else ""))
    # the rejections of the reference, raised on the card too
    g = CondGraph()
    a, b = g.task(lambda s: s), g.task(lambda s: s)
    c = g.cond(lambda s: (torch.zeros((), dtype=torch.int32,
                                      device=s["i"].device), s))
    a.precede(b)
    a.precede(c)
    c.precede(a, STOP)
    try:
        g.compile(_to(programs(TorchOps("cpu"))["dag"].state, dev))
    except ValueError as e:
        if "multiple successors" not in str(e):
            raise
    else:
        raise AssertionError("condgraph: static fan-out in a cyclic graph "
                             "was not refused on the card")
    return report


def nested_flow(flow, program: Callable[[Any], Any], m: np.ndarray,
                x: np.ndarray, scale: float):
    """Record on ``flow`` (either framework's DeviceFlow): ``x1 = x *
    scale``, the conditional ``program`` on ``{"m": m, "x": x1, "n": 0}``
    (:func:`until_small_graph`'s state: its trip count depends on the
    data), then the final ``n``, ``x`` and ``m @ x``, fetched."""
    flow.copy("m", m).copy("x", x).copy("scale", np.float32(scale))
    flow.copy("n", np.zeros((), np.int32))
    flow.kernel(lambda x, s: x * s, ["x", "scale"], ["x1"], name="scale")
    flow.kernel(lambda m, x1, n: program({"m": m, "x": x1, "n": n}),
                ["m", "x1", "n"], ["st"], name="loop")
    flow.kernel(lambda st: (st["n"], st["x"], st["m"] @ st["x"]), ["st"],
                ["n_out", "x_out", "mx"], name="reduce")
    flow.fetch("n_out", "x_out", "mx")
    return flow


#: the scales of x at successive offloads: each gives another trip count
NESTED_SCALES = (1.0, 8.0, 0.125)


def check_nested(dev: torch.device, d: int = 256,
                 log: Optional[Callable[[str], None]] = None) -> dict:
    """A DeviceFlow on ``dev`` nesting the compiled data-dependent loop
    (:func:`until_small_graph`, ``m`` of spectral norm 0.9, d x d), one
    offload per scale of :data:`NESTED_SCALES`, each held to the same op
    list around ``lower()`` run eagerly on the card (``lower()`` reads
    each condition back, which no capture allows): the trip count ``n``
    exact, fp32
    leaves within :data:`FP_REL_TOL`. One replay per offload
    (``num_launches`` +1); the program's own launch count and the
    module's WHILE-program count unchanged by every offload after the
    first (the capture builds the loop into the flow's graph once, and
    each replay runs it to its data's end). Raises ``AssertionError``;
    returns the errors, trip counts, counts and host times."""
    from repro_torch.core import STOP, CondGraph, DeviceFlow
    from repro_torch.kernels import cond_graph

    log = log or (lambda s: None)
    g = until_small_graph(CondGraph, STOP)
    st = until_small_state(d)
    m, x = st["m"].numpy(), st["x"].numpy()
    prog = g.compile(_to(st, dev))
    flow = nested_flow(DeviceFlow(dev), prog, m, x, NESTED_SCALES[0])
    plain = nested_flow(DeviceFlow(dev), g.lower(), m, x, NESTED_SCALES[0])

    def eager_plain():
        env = {k: torch.as_tensor(np.asarray(v)).to(dev)
               for k, v in plain._inputs.items()}
        return {k: v.cpu().numpy() for k, v in plain._run(env).items()}

    report = {"d": d, "max_abs_err": 0.0, "trips": [], "flow_ms": [],
              "lower_ms": []}
    counts = None
    for j, s in enumerate(NESTED_SCALES):
        flow.copy("scale", np.float32(s))
        plain.copy("scale", np.float32(s))
        launches = flow.num_launches
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = flow.offload()
        t1 = time.perf_counter()
        want = eager_plain()
        t2 = time.perf_counter()
        report["flow_ms"].append((t1 - t0) * 1e3)
        report["lower_ms"].append((t2 - t1) * 1e3)
        if flow.num_launches != launches + 1:
            raise AssertionError(
                f"nested flow: {flow.num_launches - launches} replays in "
                "one offload")
        now = (prog.num_launches, cond_graph.launches)
        if counts is not None and now != counts:
            raise AssertionError(
                f"nested flow: offload {j} changed the program's launch "
                f"counts {counts} -> {now}; a replay must not launch it")
        counts = now
        trips = int(got["n_out"])
        if trips != int(want["n_out"]) or trips < 1:
            raise AssertionError(f"nested flow: {trips} trips, lower(): "
                                 f"{int(want['n_out'])}")
        report["trips"].append(trips)
        err = _err({k: torch.from_numpy(np.asarray(v))
                    for k, v in got.items()},
                   {k: torch.from_numpy(np.asarray(v))
                    for k, v in want.items()})
        report["max_abs_err"] = max(report["max_abs_err"], err)
        if not err <= FP_REL_TOL:
            raise AssertionError(f"nested flow: offload {j} error {err:.3g} "
                                 f"against lower() (tolerance "
                                 f"{FP_REL_TOL:g})")
    if len(set(report["trips"])) < 2:
        raise AssertionError(f"nested flow: trip counts {report['trips']} "
                             "do not follow the data")
    report["program_launches"] = prog.num_launches
    report["nodes"] = prog.nodes()
    report["offloads"] = flow.num_launches
    log(f"[nested] until_small d={d}: {len(NESTED_SCALES)} offloads, one "
        f"replay each, trips {report['trips']}; error against lower() "
        f"{report['max_abs_err']:.3g}; program launches "
        f"{prog.num_launches} (the warm-up and the capture); host ms a "
        f"flow offload {[round(t, 3) for t in report['flow_ms']]} vs the "
        f"ops around lower(), eager "
        f"{[round(t, 3) for t in report['lower_ms']]}")
    return report

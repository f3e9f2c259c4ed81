"""The benchmark's harness: one cell of ``BENCHMARK.json``, run once.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* a configuration: the file its entry names (``configs/<name>.json``), whose
  ``family`` names the plain reference ``reference/<family>.py`` (weights
  layout, forward pass, loss) and whose ``port_arch`` names the program's
  own configuration of the same model;
* a traffic mix: ``traffic/<mix>.json``, whose ``kind`` names the generator
  ``traffic/<kind>.py``; the generator's ``RUNNER`` names the runner
  (``runners/serve.py`` or ``runners/train.py``) that runs the window;
* a cell: its ``BENCHMARK.json`` entry and, where the deployment needs
  settings (rows, KV pool, rate, the limits of ``correct``),
  ``cells/<cell>.json``;
* a metric: ``metrics/<metric>.py``, whose ``read(run)`` returns a number
  or None (nothing to read in this run: the metric is left out).

The harness itself names no cell, configuration or metric. A run reports
the cell's end-to-end metrics with ``--trace 0`` and its per-layer metrics
with ``--trace 1``; a metric with a ``workloads`` list is read in those
cells only.
"""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

#: top-level module names that must not be loaded once the window has
#: closed: JAX, its libraries and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: the directory of this package; the data files are looked up under the
#: benchmark directory of the spec, which is this one in a real run
HERE = Path(__file__).resolve().parent


@dataclass
class Spec:
    """A cell and the files it names."""
    root: Path                     # the directory that holds BENCHMARK.json
    bench_dir: Path                # <root>/perfbench: data files, readers
    bench: Dict[str, Any]          # BENCHMARK.json
    workload: Dict[str, Any]       # the cell's entry
    conf: Dict[str, Any]           # the configuration file
    mix: Dict[str, Any]            # the traffic file
    cell: Dict[str, Any]           # cells/<cell>.json, {} where absent

    def module(self, *parts: str):
        return load_module(self.bench_dir.joinpath(*parts))

    def reference(self):
        return self.module("reference", f"{self.conf['family']}.py")

    def generator(self):
        return self.module("traffic", f"{self.mix['kind']}.py")

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        """The cell's end-to-end metrics (trace off) or per-layer metrics
        (trace on), in ``BENCHMARK.json``'s order."""
        key = "per_layer" if trace else "end_to_end"
        name = self.workload["name"]
        return [m for m in self.bench[key]
                if name in m.get("workloads", [name])]


_MODULES: Dict[str, Any] = {}


def load_module(path: Path):
    """The Python file at ``path`` as a module, loaded once (file names
    may hold dots: a metric's file is named after the metric)."""
    key = str(path)
    if key not in _MODULES:
        name = "perfbench_" + "_".join(
            p.replace(".", "_").replace("-", "_") for p in path.parts[-2:])
        spec = importlib.util.spec_from_file_location(name, path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(f"no such benchmark file: {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path, workload: str) -> Spec:
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    bench_dir = root / "perfbench"
    cell_file = bench_dir / "cells" / f"{workload}.json"
    return Spec(root=root, bench_dir=bench_dir, bench=bench, workload=w,
                conf=read_json(root / conf_entry["file"]),
                mix=read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                cell=read_json(cell_file) if cell_file.is_file() else {})


@dataclass
class Run:
    """What one run measured: the record the metric readers read."""
    spec: Spec
    seed: int
    seconds: int
    trace: bool
    device: Any
    t_start: float                  # the process's start (perf_counter)
    setup_s: Optional[float] = None
    window: Optional[tuple] = None  # (w0, w1), perf_counter
    requests: List[Any] = field(default_factory=list)   # serve cells
    steps: Optional[Dict[str, Any]] = None               # train cells
    profile: Any = None             # trace.Profile of the traced span
    obs: Any = None                 # the engine's metrics registry
    tracer: Any = None              # the engine's span tracer
    attempted: int = 0
    failed: int = 0
    compared: Dict[str, tuple] = field(default_factory=dict)  # (value, lim)
    memory_peak_bytes: int = 0
    notes: List[str] = field(default_factory=list)

    @property
    def conf(self):
        return self.spec.conf

    @property
    def cell(self):
        return self.spec.cell

    @property
    def mix(self):
        return self.spec.mix

    def correct(self) -> bool:
        return bool(self.compared) and all(
            v is not None and _finite(v) and v <= lim
            for v, lim in self.compared.values())


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def loaded_forbidden() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, its libraries' or the JAX package's."""
    return sorted({n for n in sys.modules
                   if n.split(".", 1)[0] in FORBIDDEN_MODULES})


def card_info() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def metric_values(run: Run) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in run.spec.metrics(run.trace):
        v = run.spec.module("metrics", f"{m['name']}.py").read(run)
        if v is None:
            continue
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(run: Run) -> Dict[str, Any]:
    import torch
    dev = run.device
    if dev.type == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "count": int(run.spec.workload["chips"]),
                  "memory_peak_bytes": int(run.memory_peak_bytes)}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": int(run.memory_peak_bytes)}
    line: Dict[str, Any] = {"correct": run.correct(),
                            "attempted": int(run.attempted),
                            "failed": int(run.failed),
                            "metrics": metric_values(run),
                            "device": device}
    if run.trace and run.profile is not None:
        device["busy_s"] = run.profile.busy_s()
        device["window_s"] = run.profile.window_s
        line["breakdown"] = run.profile.breakdown(run)
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in run.compared.items()}
    return line


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: Optional[Path] = None, device: str = "cuda",
         t_start: Optional[float] = None) -> int:
    """Run one cell and print its result line; returns the exit code.
    ``device="cpu"`` skips the look for a card (the tests' small runs)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    spec = load_spec(root or HERE.parent, args.workload)
    import torch
    if device == "cuda":
        need = int(spec.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            log(f"needs {need} CUDA device(s); torch.cuda.is_available()="
                f"{torch.cuda.is_available()}, device_count="
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        log(f"card: {card_info()}")
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    run = Run(spec=spec, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=dev, t_start=t_start)
    runner = importlib.import_module(
        f"perfbench.runners.{spec.generator().RUNNER}")
    runner.run(run)
    found = loaded_forbidden()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 3
    line = result_line(run)
    for note in run.notes:
        log(note)
    for k, c in line["compared"].items():
        log(f"compared {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(line), flush=True)
    return 0

"""Roofline table of the port's dry run (the counterpart of
``benchmarks/roofline_report.py``): the records of
:mod:`repro_torch.launch.dryrun` as one row per cell, with the three terms,
the dominant one, the useful-flops fraction, the fits-80-GB flag and a
kind-aware efficiency (a decode cell is judged against the bytes it must
stream each step: every active parameter on its card plus its cache and
state, which are the record's argument bytes).

The constants are the dry run's (the H100 SXM datasheet peaks). The
``roofline`` suite of :mod:`repro_torch.bench.run` first dry-runs the cells
the records file lacks (``--quick``: stablelm-1.6b's prefill and decode
cells on the ``node`` mesh, seconds; otherwise every cell on both meshes,
tens of minutes), then reports; it runs on the CPU and allocates nothing
on a device.

    PYTHONPATH=src python -m repro_torch.bench.roofline_report [records]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from ..configs import ARCHS, SHAPES_BY_NAME, get_config
from ..launch import dryrun

__all__ = ["load", "rows", "bench", "markdown", "COLUMNS",
           "DEFAULT_RECORDS"]

DEFAULT_RECORDS = "results/dryrun.jsonl"

#: a table row's keys, in column order
COLUMNS = ("arch", "shape", "mesh", "peak_gb", "fits", "compute_s",
           "memory_s", "collective_s", "dominant", "useful", "frac")


def load(path=DEFAULT_RECORDS, tag: str = "") -> dict:
    """The last ``ok`` record of each (arch, shape, mesh) with ``tag``."""
    seen = {}
    p = Path(path)
    if not p.exists():
        return {}
    for line in p.read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:
            continue
        if r.get("ok") and r.get("tag", "") == tag:
            seen[(r["arch"], r["shape"], r["mesh"])] = r
    return seen


def decode_min_bytes(arch: str) -> float:
    """Every active parameter read once by a decode step: each card
    gathers the weights and runs its rows through all of them (bf16 or
    fp32 as the config holds them)."""
    cfg = get_config(arch)
    return cfg.active_param_count() * (2 if cfg.param_dtype == "bfloat16"
                                       else 4)


def rows(path=DEFAULT_RECORDS, tag: str = "") -> list:
    out = []
    for (a, s, m), r in sorted(load(path, tag).items()):
        rf = r["roofline"]
        rec = {
            "arch": a, "shape": s, "mesh": m,
            "peak_gb": r["memory"]["peak_bytes"] / 1e9,
            "fits": r["memory"]["fits_80gb"],
            "compute_s": rf["compute_s"],
            "memory_s": rf["memory_s"],
            "collective_s": rf["collective_s"],
            "dominant": rf["dominant"],
            "useful": rf["useful_flops_frac"],
            "frac": rf["roofline_frac"],
        }
        if r["kind"] == "decode":
            mem = r["memory"]
            minb = decode_min_bytes(a) + mem["argument_bytes"] \
                - mem["param_bytes"]           # + the cache and the tokens
            rec["frac"] = min(1.0, (minb / dryrun.HBM_BW)
                              / max(rf["memory_s"], rf["collective_s"],
                                    rf["compute_s"], 1e-12))
            rec["dominant"] += " (bw-bound)"
        out.append(rec)
    return out


def bench(quick: bool = False, path=DEFAULT_RECORDS, log=None):
    """The suite: dry-run the cells ``path`` lacks, then one row per
    cell, ``roofline/<arch>/<shape>/<mesh>``, its fraction of the roofline
    with the dominant term and the peak."""
    archs = ["stablelm-1.6b"] if quick else list(ARCHS)
    shapes = ["prefill_32k", "decode_32k"] if quick else list(SHAPES_BY_NAME)
    meshes = ["node"] if quick else ["node", "multi"]
    have = load(path)
    todo = [c for c in dryrun.cells(archs, shapes, meshes)
            if c[2] is not None and (c[0], c[1],
                                     dryrun.MESHES[c[2]][2]) not in have]
    for arch, shape, m, _ in todo:
        if dryrun.run([arch], [shape], [m], Path(path),
                      log=log or (lambda msg: None)):
            raise RuntimeError(f"dry run of {arch} x {shape} x {m} failed "
                               f"(its record in {path})")
    for r in rows(path):
        yield (f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
               f"{r['frac']:.4f}",
               f"dom={r['dominant']} peak={r['peak_gb']:.1f}GB "
               f"fits={'Y' if r['fits'] else 'N'}")


def markdown(path=DEFAULT_RECORDS, tag: str = "") -> str:
    lines = [f"Roofline of the port's dry run ({dryrun.CARD})", "",
             "| arch | shape | mesh | peak GB | fits 80 GB | compute s | "
             "memory s | collective s | dominant | useful | frac |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows(path, tag):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['peak_gb']:.2f} | {'Y' if r['fits'] else 'N'} | "
            f"{r['compute_s']:.4f} | {r['memory_s']:.4f} | "
            f"{r['collective_s']:.4f} | {r['dominant']} | "
            f"{r['useful']:.2f} | {r['frac']:.3f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown(*sys.argv[1:2]))

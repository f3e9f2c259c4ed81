"""Dry run of every (arch x shape x mesh) cell on H100 meshes: what one
card holds and moves for a step, with no device allocation (the port's
counterpart of ``repro.launch.dryrun``).

For each cell this script:

1. builds the mesh: ``node``, one node of 8 cards (``data`` 8 x ``model``
   1), or ``multi``, 4 such nodes (``pod`` 4 x ``data`` 8 x ``model`` 1).
   Every card is on ``dp``: the port's ``tp`` axis shards storage, not
   compute (ROADMAP Queue 3), so a ``model`` axis above 1 would only add
   gathers and repeat each row's work;
2. builds the step of the shape's kind (the sharded train step, or the
   prefill or decode step) and meta tensors of rank 0's inputs, its blocks
   under the rule table (:mod:`repro_torch.train.train_step`);
3. runs the step on the meta device, rank 0 of the mesh, with a dry-run
   group standing in for the process groups
   (:func:`repro_torch.distributed.op_analysis.analyze_step`): FLOPs,
   bytes accessed, collective bytes and counts by type and by link, and
   the peak of live storage (arguments plus temporaries);
4. derives the three roofline terms against the H100 SXM datasheet peaks
   and appends a JSON record with the reference's keys to ``--out``
   (``fits_80gb`` where the reference has ``fits_16gb``; ``lower_s`` is
   the time to build the step and its inputs, ``compile_s`` the meta run;
   ``*_rawca`` repeat the counts, which need no loop correction).

Usage::

    python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --mesh node
    python -m repro_torch.launch.dryrun --all [--mesh node|multi|both] [--variant opt]

It runs on the CPU and allocates nothing on a device, so it needs no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

from ..configs import ARCHS, SHAPES_BY_NAME, get_config, shape_applicable
from ..distributed.op_analysis import DryMeshGroup, StepCost, analyze_step
from ..distributed.sharding import Mesh
from ..optim.adamw import OptConfig
from ..tree import leaves
from ..train.train_step import (make_decode_step, make_prefill_step,
                                train_input_specs)
from .mesh import make_ctx

__all__ = ["CARD", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "INTERNODE_BW",
           "HBM_BYTES", "MESHES", "apply_variant", "build_cell", "run_cell",
           "model_flops", "main"]

# --------------------------------------------- H100 SXM, datasheet peaks
#: the card the constants are for
CARD = "NVIDIA H100 80GB HBM3 (SXM5), 700 W, datasheet peaks"
PEAK_FLOPS = 989e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12         # HBM3 bytes/s
NVLINK_BW = 450e9        # NVLink 4 bytes/s a direction, a card
#: inter-node bytes/s a card: one 400 Gb/s NDR InfiniBand NIC per card, as
#: an 8-card H100 node carries them
INTERNODE_BW = 50e9
HBM_BYTES = 80e9         # device memory a card

#: the dry run's meshes: name -> (shape, axis names, label)
MESHES = {
    "node": ((8, 1), ("data", "model"), "8x1"),
    "multi": ((4, 8, 1), ("pod", "data", "model"), "4x8x1"),
}


def apply_variant(cfg, variant: str):
    """``opt`` switches on the beyond-paper optimizations, as the
    reference's: score recompute in attention's backward, the hoisted
    weight gather below 5e9 parameters (its bf16 copy costs 2 bytes a
    parameter, 10 GB at 5e9), the constrained scan and the MoE experts
    padded to a multiple of 16; baseline keeps the first implementation."""
    if variant != "opt":
        return cfg
    pad = -cfg.num_experts % 16 if cfg.moe and cfg.num_experts % 16 else 0
    return dataclasses.replace(
        cfg, attn_bwd_remat=True,
        hoist_weight_gather=cfg.param_count() < 5e9,
        ssm_scan_constrain=True, moe_expert_pad=pad)


def model_flops(cfg, shape) -> float:
    """6 * N_active * tokens (train: forward and backward); 2 * N_active *
    tokens to serve."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return (6.0 if shape.kind == "train" else 2.0) * n * tokens


def build_cell(arch: str, shape_name: str, mesh_name: str,
               variant: str = ""):
    """(cfg, shape, mesh, cost, step, meta inputs) of one cell, rank 0's."""
    cfg = apply_variant(get_config(arch), variant)
    shape = SHAPES_BY_NAME[shape_name]
    dims, axes, _ = MESHES[mesh_name]
    mesh = Mesh(dims, axes)
    cost = StepCost()
    ctx = make_ctx(mesh, DryMeshGroup(mesh, 0, cost))
    if shape.kind == "train":
        # >1e11 parameters: bf16 moments, as the reference
        opt = OptConfig(moment_dtype="bfloat16"
                        if cfg.param_count() > 1e11 else "float32")
        step, args, _ = train_input_specs(cfg, ctx, shape, opt=opt)
    elif shape.kind == "prefill":
        step, args, _ = make_prefill_step(cfg, ctx, shape)
    else:
        step, args, _ = make_decode_step(cfg, ctx, shape)
    return cfg, shape, mesh, cost, step, args


def run_cell(arch: str, shape_name: str, mesh_name: str,
             extra_tag: str = "", variant: str = "") -> dict:
    """One cell's record (the reference's keys)."""
    t0 = time.time()
    cfg, shape, mesh, cost, step, args = build_cell(arch, shape_name,
                                                    mesh_name, variant)
    t_build = time.time() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(args[0]))
    analyze_step(step, *args, cost=cost)
    del args
    t_run = time.time() - t0 - t_build
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.bytes_accessed / HBM_BW
    collective_s = cost.link_bytes["nvlink"] / NVLINK_BW \
        + cost.link_bytes["internode"] / INTERNODE_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bound_s = max(terms.values())
    mf = model_flops(cfg, shape)
    mf_per_dev = mf / mesh.size
    return {
        "arch": arch, "shape": shape_name, "mesh": MESHES[mesh_name][2],
        "chips": mesh.size, "kind": shape.kind, "tag": extra_tag,
        "ok": True, "card": CARD,
        "lower_s": round(t_build, 1), "compile_s": round(t_run, 1),
        "memory": {
            "argument_bytes": cost.argument_bytes,
            "output_bytes": cost.output_bytes,
            "temp_bytes": cost.temp_bytes,
            "peak_bytes": cost.peak_bytes,
            "param_bytes": param_bytes,
            "fits_80gb": cost.peak_bytes < HBM_BYTES,
        },
        "flops_per_dev": cost.flops,
        "bytes_per_dev": cost.bytes_accessed,
        "flops_per_dev_rawca": cost.flops,
        "bytes_per_dev_rawca": cost.bytes_accessed,
        "unknown_trip_loops": cost.unknown_trip_loops,
        "collective_bytes": cost.collective_bytes,
        "collective_counts": cost.collective_counts,
        "collective_bytes_total": cost.collective_total,
        "collective_link_bytes": cost.link_bytes,
        "roofline": {
            **terms, "dominant": max(terms, key=terms.get),
            "step_lower_bound_s": bound_s,
            "model_flops_global": mf,
            "model_flops_per_dev": mf_per_dev,
            "useful_flops_frac": (mf_per_dev / cost.flops
                                  if cost.flops else 0.0),
            "roofline_frac": ((mf_per_dev / PEAK_FLOPS) / bound_s
                              if bound_s else 0.0),
        },
    }


def cells(archs, shapes, meshes):
    """(arch, shape, mesh or None with the skip reason) in run order."""
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            ok, why = shape_applicable(cfg, SHAPES_BY_NAME[shape_name])
            if not ok:
                yield arch, shape_name, None, why
                continue
            for m in meshes:
                yield arch, shape_name, m, ""


def run(archs, shapes, meshes, out: Path, tag: str = "", variant: str = "",
        skip_done: bool = False, log=print) -> int:
    """Append every cell's record to ``out``; returns the failures."""
    out.parent.mkdir(parents=True, exist_ok=True)
    done = set()
    if skip_done and out.exists():
        for line in out.read_text().splitlines():
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("ok"):
                done.add((r["arch"], r["shape"], r["mesh"], r.get("tag", "")))
    n_ok = n_skip = n_fail = 0
    for arch, shape_name, m, why in cells(archs, shapes, meshes):
        if m is None:
            log(f"[skip] {arch} x {shape_name}: {why}")
            rec = {"arch": arch, "shape": shape_name, "mesh": "-",
                   "ok": False, "skipped": True, "why": why, "tag": tag}
            n_skip += 1
        elif (arch, shape_name, MESHES[m][2], tag) in done:
            log(f"[done] {arch} x {shape_name} x {MESHES[m][2]}")
            continue
        else:
            log(f"[run ] {arch} x {shape_name} x {MESHES[m][2]} ...")
            try:
                rec = run_cell(arch, shape_name, m, extra_tag=tag,
                               variant=variant)
                r = rec["roofline"]
                log(f"       ok  meta run {rec['compile_s']}s peak="
                    f"{rec['memory']['peak_bytes'] / 1e9:.2f}GB "
                    f"dom={r['dominant']} roofline_frac="
                    f"{r['roofline_frac']:.3f}")
                n_ok += 1
            except Exception as e:  # noqa: BLE001 — recorded, run goes on
                rec = {"arch": arch, "shape": shape_name,
                       "mesh": MESHES[m][2], "ok": False, "tag": tag,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                log(f"       FAIL {type(e).__name__}: {e}")
                n_fail += 1
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
    log(f"dryrun complete: ok={n_ok} skip={n_skip} fail={n_fail}")
    return n_fail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["node", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every arch and shape (the default without "
                         "--arch / --shape)")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--tag", default="")
    ap.add_argument("--variant", default="", choices=["", "opt"])
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)
    if args.variant and not args.tag:
        args.tag = args.variant
    archs = [args.arch] if args.arch and not args.all else list(ARCHS)
    shapes = [args.shape] if args.shape and not args.all \
        else list(SHAPES_BY_NAME)
    meshes = ["node", "multi"] if args.mesh == "both" else [args.mesh]
    return 1 if run(archs, shapes, meshes, Path(args.out), args.tag,
                    args.variant, args.skip_done,
                    log=lambda m: print(m, flush=True)) else 0


if __name__ == "__main__":
    sys.exit(main())

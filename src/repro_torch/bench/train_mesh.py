"""Sharded training against the single-device step.

The bodies a :class:`repro_torch.launch.mesh.MeshSession` runs on every
rank, and the single-device run they are held to:

* :class:`TrainRun`: one configuration (arch, preset, config overrides,
  batch, steps, microbatches, hoisting, mesh); :func:`build` draws its fp32
  masters from a seeded ``torch.Generator`` on the device, the same on
  every rank and in the single-device run;
* :class:`Runs`: a session's body, the runs one after another on this
  rank's :class:`~repro_torch.distributed.sharding.MeshGroup` (one per
  mesh shape), each reporting the rank's state bytes against what its
  specs give, its peak device memory, its collectives, its step walls, the
  run's wall (its weights built and placed too), its kernel launches,
  its blocks' shapes and (rank 0) the metrics and, if asked, the whole
  state gathered into host memory; or, for a state too large to gather
  through the host (``vs_single``), every rank in turn runs the
  single-device steps on its device and holds its own blocks against the
  same blocks of that state there. A run on a mesh with a ``model`` axis
  takes the step its arch takes there
  (:func:`repro_torch.distributed.sharding.tp_compute`);
* :class:`ServeRun`: one sharded serve configuration, run by the same
  :class:`Runs` body: its prompts through the partitioned prefill step
  into a sequence-parallel cache, then greedy decode steps
  (:func:`repro_torch.train.train_step.make_prefill_step`,
  ``make_decode_step``), each rank reporting its rows' tokens and logits,
  its KV bytes, its collectives of each step and its kernel launches,
  and rank 0 the same prompts on one device beside them, through the
  kernels and through the plain path;
* :func:`single_run`: the same steps through the single-device step;
* :func:`compare_states`: the largest differences between two states
  (metrics, moments per leaf, params in units of lr), the params split by
  how well-conditioned AdamW's first step is;
* :class:`TrainerBody` and :func:`main`: ``Trainer(ctx=)`` on a mesh of
  ranks from the command line (``python -m repro_torch.bench.train_mesh
  --device cpu``).

Under ``gloo`` on one card every collective is staged through host
memory: the walls are no distributed-training speed.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["TrainRun", "ServeRun", "Runs", "TrainerBody", "build",
           "single_run", "compare_states", "batches", "main"]


@dataclasses.dataclass(frozen=True)
class TrainRun:
    """One sharded training configuration (picklable)."""
    name: str
    arch: str = "stablelm-1.6b"
    preset: str = "full"
    overrides: Tuple[Tuple[str, Any], ...] = ()
    batch: int = 2
    seq: int = 2048
    steps: int = 1
    microbatches: Optional[int] = None
    mesh: Tuple[int, int] = (2, 1)
    lr: float = 1e-3
    seed: int = 0
    keep: bool = False      # rank 0 returns the whole state after the run
    vs_single: bool = False  # each rank holds its blocks against one device

    def config(self):
        from ..configs import get_config
        cfg = get_config(self.arch)
        if self.preset == "smoke":
            cfg = cfg.smoke()
        return dataclasses.replace(cfg, **dict(self.overrides))

    def opt(self):
        from ..optim import OptConfig
        return OptConfig(lr=self.lr, warmup_steps=0,
                         total_steps=max(10, self.steps))


@dataclasses.dataclass(frozen=True)
class ServeRun:
    """One sharded serve configuration (picklable): ``batch`` prompts of
    ``prompt`` tokens prefilled into a ``max_len`` cache on ``mesh``, then
    ``steps`` greedy decode steps; the weights are served ones (matrices
    in the compute dtype) from the same seeded generator as
    :class:`TrainRun`'s."""
    name: str
    arch: str = "stablelm-1.6b"
    preset: str = "full"
    overrides: Tuple[Tuple[str, Any], ...] = ()
    batch: int = 2
    prompt: int = 512
    max_len: int = 1024
    steps: int = 8
    mesh: Tuple[int, int] = (1, 2)
    seed: int = 0
    serve_tp_only: bool = False   # decode on weights resident whole over
    #                               fsdp (make_decode_step's option)

    config = TrainRun.config


def build(run: TrainRun, device) -> Tuple[Any, Dict[str, Any]]:
    """``run``'s config and fp32 masters, drawn on ``device``."""
    from ..params import init_params
    cfg = run.config()
    g = torch.Generator(device).manual_seed(run.seed)
    return cfg, init_params(cfg, g, device=device, cast=False)


def batches(run: TrainRun, cfg):
    """The global batch of each step (the same on every rank); a frontend
    arch's frames are standard normal, drawn after the tokens."""
    for i in range(run.steps):
        rng = np.random.default_rng(run.seed + 1 + i)
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (run.batch, run.seq)).astype(np.int32))}
        if cfg.frontend != "none":
            b["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
                (run.batch, cfg.frontend_tokens, cfg.d_model),
                dtype=np.float32))
        yield b


def _bytes(tree) -> int:
    from ..tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _walls_and_metrics(step, params, opt_state, run, cfg, device, keep_rank):
    hist, walls = [], []
    for batch in batches(run, cfg):
        batch = {k: v.to(device) for k, v in batch.items()}
        _sync(device)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        names = sorted(m)
        vals = torch.stack([m[k].float() for k in names]).tolist()
        walls.append(time.perf_counter() - t0)
        if keep_rank:
            hist.append(dict(zip(names, vals)))
    return params, opt_state, hist, walls


@dataclasses.dataclass(frozen=True)
class Runs:
    """A :class:`~repro_torch.launch.mesh.MeshSession` body: each of
    ``runs`` on this rank (a rank off a run's mesh skips it)."""
    runs: Tuple[TrainRun, ...]
    op_timeout_s: float = 600.0

    def __call__(self, device) -> list:
        from ..launch.mesh import mesh_ctx, small_mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        ctxs, out = {}, []
        for run in self.runs:
            if run.mesh not in ctxs:
                ctxs[run.mesh] = mesh_ctx(small_mesh(*run.mesh), device,
                                          self.op_timeout_s)
            ctx = ctxs[run.mesh]
            t0 = time.perf_counter()
            body = _serve if isinstance(run, ServeRun) else _sharded
            out.append(None if ctx is None else dict(
                body(run, ctx, device), run_s=time.perf_counter() - t0))
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
        return out


def _sharded(run: TrainRun, ctx, device) -> Dict[str, Any]:
    from ..kernels import ops
    from ..optim import init_opt_state
    from ..train.checkpoint import gather_to_host
    from ..train.elastic import reshard_state
    from ..train.train_step import (make_train_step, opt_shardings,
                                    param_shardings)
    from ..tree import leaves
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, full = build(run, dev)
    full_bytes = _bytes(full)
    pshard = param_shardings(cfg, ctx)
    spec_bytes = sum(s.nbytes(t.shape, t.dtype) for s, t in
                     zip(leaves(pshard), leaves(full)))
    shapes = [(tuple(t.shape), [e for e in s.spec])
              for s, t in zip(leaves(pshard), leaves(full))]
    params = reshard_state(cfg, {"params": full}, ctx)["params"]
    del full
    opt_state = init_opt_state(params, run.opt())
    step = make_train_step(cfg, run.opt(), microbatches=run.microbatches,
                           ctx=ctx)
    ctx.group.reset_counters()
    before = ops.launch_counts()
    params, opt_state, hist, walls = _walls_and_metrics(
        step, params, opt_state, run, cfg, dev,
        ctx.group.rank == 0 or run.vs_single)
    after = ops.launch_counts()
    res = {"name": run.name, "rank": ctx.group.rank,
           "param_bytes": _bytes(params),
           "moment_bytes": _bytes(opt_state["m"]) + _bytes(opt_state["v"]),
           "spec_bytes": spec_bytes, "full_bytes": full_bytes,
           "leaf_shapes_specs": shapes,
           "block_shapes": [tuple(t.shape) for t in leaves(params)],
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
           else None,
           "counters": ctx.group.counters(), "walls": walls,
           "history": hist,
           "launches": {k: after[k] - before.get(k, 0) for k in after}}
    if run.keep:
        tree = {"params": params, "m": opt_state["m"], "v": opt_state["v"]}
        shard = {"params": pshard,
                 "m": opt_shardings(cfg, ctx, pshard)["m"],
                 "v": opt_shardings(cfg, ctx, pshard)["v"]}
        res["whole"] = gather_to_host(tree, shard, ctx.group)
    if run.vs_single:
        res["vs_single"] = _blocks_vs_single(
            run, ctx, dev, pshard, hist,
            {"params": params, "m": opt_state["m"], "v": opt_state["v"]})
    return res


def _serve_steps(prefill, decode, params, tokens, rows, steps, dev,
                 group=None):
    """The prompts' prefill and ``steps`` greedy decode steps: (tokens (B_r,
    steps + 1), each step's logits, the cache, the walls, each step's
    collectives). A step reads its ``rows`` of the global tokens."""
    B = tokens.shape[0]
    counters = []

    def timed(fn, *args):
        if group is not None:
            group.reset_counters()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(dev)
        if group is not None:
            counters.append(group.counters())
        return out, time.perf_counter() - t0

    (logits, cache), w = timed(prefill, params, tokens)
    walls, out = [w], [logits.float().cpu()]
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks = [tok]
    for _ in range(steps):
        glob = torch.zeros((B,), dtype=torch.int32, device=dev)
        glob[rows] = tok
        (logits, cache), w = timed(decode, params, cache, glob)
        walls.append(w)
        out.append(logits.float().cpu())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1).cpu(), out, cache, walls, counters


def _kv_bytes(cache) -> int:
    from ..distributed.sharding import KV_LEAVES
    return sum(cache[k].numel() * cache[k].element_size()
               for k in KV_LEAVES if k in cache)


def _serve(run: ServeRun, ctx, device) -> Dict[str, Any]:
    """``run`` on this rank: the partitioned prefill and decode steps on
    its blocks (:func:`_serve_steps`). Rank 0 then runs the same prompts
    on one device from the whole weights twice: through the kernels, as
    the ranks do, and through the plain path (``lm.prefill``'s
    ``"chunked"`` attention or ``"plain"`` scan: no hand-written kernel),
    its rows' logits of every step held beside the ranks' and its block of
    the plain run's final cache beside its own."""
    from ..configs import ShapeSpec
    from ..distributed.sharding import cache_block
    from ..kernels import ops
    from ..models import lm
    from ..params import init_params
    from ..train.elastic import reshard_state
    from ..train.train_step import (_serve_rows, make_decode_step,
                                    make_prefill_step)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = run.config()
    full = init_params(cfg, torch.Generator(dev).manual_seed(run.seed),
                       device=dev, cast=True)
    params = reshard_state(cfg, {"params": full}, ctx)["params"]
    dparams = reshard_state(cfg, {"params": full}, dataclasses.replace(
        ctx, fsdp=None))["params"] if run.serve_tp_only else params
    single = ctx.group.rank == 0
    if not single:
        del full
    tokens = torch.from_numpy(np.random.default_rng(run.seed + 1).integers(
        0, cfg.vocab_size, (run.batch, run.prompt)).astype(np.int32)
    ).to(dev)
    prefill, _, _ = make_prefill_step(
        cfg, ctx, ShapeSpec("p", run.prompt, run.batch, "prefill"),
        max_len=run.max_len)
    decode, _, _ = make_decode_step(
        cfg, ctx, ShapeSpec("d", run.max_len, run.batch, "decode"),
        serve_tp_only=run.serve_tp_only)
    rows = _serve_rows(ctx, run.batch)
    before = ops.launch_counts()
    toks, logits, cache, walls, counters = _serve_steps(
        lambda p, t: prefill(p, {"tokens": t}),
        lambda p, c, t: decode(dparams, c, t), params, tokens, rows,
        run.steps, dev, ctx.group)
    after = ops.launch_counts()
    res = {"name": run.name, "rank": ctx.group.rank,
           "rows": (rows.start, rows.stop), "tokens": toks.numpy(),
           "walls": walls, "prefill_counters": counters[0],
           "decode_counters": counters[1:], "kv_bytes": _kv_bytes(cache),
           "kv_shape": tuple(cache["k" if "k" in cache else "shared_k"]
                             .shape) if not cfg.attention_free else None,
           "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
           else None,
           "launches": {k: after[k] - before.get(k, 0) for k in after}}
    del dparams, params
    if not single:
        return res
    gc.collect()

    def one_device(impl):
        return _serve_steps(
            lambda p, t: lm.prefill(cfg, p, t, run.max_len, impl=impl),
            lambda p, c, t: lm.decode_step(cfg, p, c, t), full, tokens,
            slice(0, run.batch), run.steps, dev)
    one = one_device(None)
    res.update(single_tokens=one[0][rows].numpy(),
               single_kv_bytes=_kv_bytes(one[2]),
               logits_max_abs=max(float((a - b[rows]).abs().max())
                                  for a, b in zip(logits, one[1])),
               single_walls=one[3])
    del one
    gc.collect()
    plain = one_device("plain" if cfg.ssm and not cfg.hybrid_attn_every
                       else "chunked")
    mine = cache_block(cfg, ctx, run.batch, plain[2])
    diffs = [(float((a.float() - b.float()).abs().max()),
              float(b.float().abs().max()))
             for a, b in zip(_cache_leaves(cache), _cache_leaves(mine))]
    res.update(plain_tokens=plain[0][rows].numpy(),
               plain_logits_max_abs=[float((a - b[rows]).abs().max())
                                     for a, b in zip(logits, plain[1])],
               plain_logits_std=[float(b[rows].std()) for b in plain[1]],
               plain_cache_max_abs=max(d for d, _ in diffs),
               plain_cache_rel=max(d / max(1.0, m) for d, m in diffs))
    del plain, mine, cache, full
    return res


def _cache_leaves(cache) -> list:
    """A decode cache's tensors in key order (``pos`` left out)."""
    out = []
    for k in sorted(cache):
        v = cache[k]
        if k != "pos":
            out.extend(v if isinstance(v, tuple) else (v,))
    return out


def _blocks_vs_single(run: TrainRun, ctx, dev, pshard, hist, state
                      ) -> Dict[str, Any]:
    """:func:`compare_states` of this rank's blocks against the same
    blocks of the single-device steps' state, which each rank runs in turn
    on its device (the others wait at a barrier holding their blocks), so
    no state crosses the host; with the single run's peak memory."""
    from ..tree import leaves, unflatten
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = None
    rank = ctx.group.rank
    for r in range(ctx.group.mesh.size):
        if r == rank:
            one = single_run(run, dev, host=False)
            want = {k: unflatten(t, [sh.shard(x, rank) for x, sh in
                                     zip(leaves(t), leaves(pshard))])
                    for k, t in one["whole"].items()}
            out = dict(compare_states(state, want, hist, one["history"],
                                      run.lr),
                       single_peak_bytes=one["peak_bytes"],
                       single_history=one["history"])
            del one, want
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        ctx.group.barrier()
    return out


def single_run(run: TrainRun, device, host: bool = True) -> Dict[str, Any]:
    """``run``'s steps through the single-device step on ``device``: its
    metrics per step, walls, peak memory and whole final state (in host
    memory, or with ``host`` False where it is)."""
    from ..optim import init_opt_state
    from ..train.train_step import make_train_step
    from ..tree import tree_map
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, params = build(run, dev)
    opt_state = init_opt_state(params, run.opt())
    dp = run.mesh[0]
    mb = run.microbatches if run.microbatches is not None \
        else max(1, run.batch // dp)
    step = make_train_step(cfg, run.opt(), microbatches=mb)
    params, opt_state, hist, walls = _walls_and_metrics(
        step, params, opt_state, run, cfg, dev, True)
    whole = {"params": params, "m": opt_state["m"], "v": opt_state["v"]}
    if host:
        whole = tree_map(lambda t: t.detach().to("cpu", copy=True), whole)
    return {"history": hist, "walls": walls, "whole": whole,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda
            else None}


def compare_states(got: Dict[str, Any], want: Dict[str, Any],
                   got_hist: list, want_hist: list, lr: float,
                   eps: float = 1e-8, b1: float = 0.9) -> Dict[str, float]:
    """The largest differences of ``got`` from ``want`` (whole states:
    ``params``, ``m``, ``v``): each metric relative, each moment leaf
    relative to its largest magnitude, and the params in units of lr,
    split where AdamW's first step is well-conditioned from where ``want``'s
    first moment shows a gradient within 100 eps of zero (there the step
    g / (|g| + eps) may move a weight by up to 2 lr more or less)."""
    from ..tree import leaves
    out = {"metric_rel": 0.0, "m_rel": 0.0, "v_rel": 0.0,
           "param_lr": 0.0, "ill_param_lr": 0.0, "ill": 0}
    for hg, hw in zip(got_hist, want_hist):
        for k in hw:
            out["metric_rel"] = max(out["metric_rel"], abs(
                hg[k] - hw[k]) / max(abs(hw[k]), 1e-30))
    for k in ("m", "v"):
        for a, b in zip(leaves(got[k]), leaves(want[k])):
            scale = float(b.abs().max()) if b.numel() else 0.0
            err = float((a - b).abs().max()) if b.numel() else 0.0
            out[f"{k}_rel"] = max(out[f"{k}_rel"], err / max(scale, 1e-30))
    cut = 100 * eps * (1 - b1)
    for a, b, m in zip(leaves(got["params"]), leaves(want["params"]),
                       leaves(want["m"])):
        err = (a - b).abs() / lr
        ill = m.abs() <= cut
        if (~ill).any():
            out["param_lr"] = max(out["param_lr"], float(err[~ill].max()))
        if ill.any():
            out["ill_param_lr"] = max(out["ill_param_lr"],
                                      float(err[ill].max()))
        out["ill"] += int(ill.sum())
    return out


@dataclasses.dataclass(frozen=True)
class TrainerBody:
    """A session body (picklable): ``Trainer(ctx=)`` on a ``data x model``
    mesh, every rank one trainer; returns rank 0's history and each rank's
    state bytes."""
    run: TrainRun
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50

    def __call__(self, device) -> Dict[str, Any]:
        from ..launch.mesh import mesh_ctx, small_mesh
        from ..train import Trainer, TrainerConfig
        run = self.run
        ctx = mesh_ctx(small_mesh(*run.mesh), device)
        if ctx is None:
            return {}
        tc = TrainerConfig(total_steps=run.steps, log_every=1,
                           ckpt_every=self.ckpt_every,
                           microbatches=run.microbatches, seed=run.seed)
        out = Trainer(run.config(), tc, run.batch, run.seq, opt=run.opt(),
                      ckpt_dir=self.ckpt_dir, ctx=ctx).run()
        st = out["state"]
        return {"rank": ctx.rank, "history": out["history"],
                "param_bytes": _bytes(st["params"]),
                "moment_bytes": _bytes(st["opt"]["m"])
                + _bytes(st["opt"]["v"]),
                "counters": ctx.group.counters()}


def main(argv=None) -> int:
    """``Trainer(ctx=)`` on ``--data x --model`` ranks, this process rank 0
    and the others spawned, all on ``--device`` (``gloo``) or one card a
    rank (``nccl``)."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--preset", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: its own)")
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--hoist", action="store_true",
                    help="hoist_weight_gather: one bf16 gather a step")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None,
                    help="every gloo rank's device (default cuda:0)")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..launch.mesh import MeshSession
    world = args.data * args.model
    over = (("hoist_weight_gather", args.hoist),) + (
        (("num_layers", args.layers),) if args.layers else ())
    run = TrainRun("cli", args.arch, args.preset, over, args.batch,
                   args.seq, args.steps, args.microbatches,
                   (args.data, args.model), lr=3e-4)
    dev = resolve_device(args.device)
    devices = [torch.device("cuda", r) for r in range(world)] \
        if args.backend == "nccl" else None
    t0 = time.perf_counter()
    with MeshSession(world, args.backend,
                     TrainerBody(run, args.ckpt_dir), dev,
                     devices=devices) as s:
        s.run()
    for h in s.results[0]["history"]:
        print(f"step {h['step']} loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f}")
    print(f"{world} ranks ({args.data} x {args.model}, {args.backend}) in "
          f"{time.perf_counter() - t0:.1f} s; params a rank "
          f"{[r['param_bytes'] for r in s.results]} B, moments "
          f"{[r['moment_bytes'] for r in s.results]} B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Tensor-parallel serving against the single-device engine.

The port of ``benchmarks/serve_continuous.py::bench_mesh`` (the
``serve_mesh`` suite) and of the parity matrix of
``tests/test_serve_mesh.py``. Rank 0 is this process; the other ranks are
spawned (:class:`repro_torch.launch.mesh.TPSession`) and follow its
engines (:mod:`repro_torch.serve.tp`).

* :func:`parity_matrix`: the same prompts through the single-device engine
  and through ``ServeEngine(tp=...)`` in sync and async decode, with the
  prefix cache off and on; prompt lengths straddle the prefill window and
  the block size (chunked prefill, block growth), and two prompts share
  prompt 0's first 16 and first 12 tokens (cache hits; the 12-token one
  forks a partially matched block copy-on-write). Each case reports its
  tokens' equality, the engine's stats, rank 0's pool bytes and the
  collectives' counters by op.
* :func:`probe_logits` / :class:`ProbeThenFollow`: the prefill logits of
  one batch on every rank's shard, for the largest logit difference
  against the single-device model.
* :func:`column_slice_params`: the single-device weights, wrapped so that
  every product with a weight a rank would hold a column slice of is
  computed as the ranks compute it (one product per slice, contiguous, the
  results concatenated): a single-device engine on them does the ranks'
  arithmetic, to tell the products' shapes from the group's plumbing when
  a multi-rank engine's tokens differ from the single engine's.
* :func:`bench_mesh`: the reference's rows, mesh against single tok/s and
  latency over one seeded Poisson trace, per-rank pool bytes and the
  admission capacity at a fixed per-rank byte budget, parity asserted.

Under ``gloo`` on one card (or the CPU) every all-gather is staged through
host memory: its tok/s and latency are not a tensor-parallel speed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["parity_prompts", "run_case", "parity_matrix", "probe_logits",
           "ProbeThenFollow", "FollowEach", "bench_mesh", "MATRIX",
           "PARITY_KW", "ColumnSlices", "column_slice_params"]

#: (async_decode, prefix_cache) of the parity matrix
MATRIX = ((False, False), (False, True), (True, False), (True, True))
#: the engine geometry of the parity matrix (the reference test's)
PARITY_KW = dict(decode_chunk=4, max_batch=4, kv_blocks=48, block_size=8,
                 max_admit=2)


def parity_prompts(vocab: int, seed: int = 0) -> List[np.ndarray]:
    """The reference test's prompts: lengths 23, 5, 9, 41, 17, 21 (41
    streams across several prefill windows, the short ones grow blocks);
    prompt 4 shares prompt 0's first 16 tokens (two whole blocks) and
    prompt 5 its first 12 (a block and a half: a copy-on-write fork)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, vocab, size=n).astype(np.int32)
               for n in (23, 5, 9, 41, 17, 21)]
    prompts[4] = np.concatenate([prompts[0][:16], prompts[4][16:]])
    prompts[5] = np.concatenate([prompts[0][:12], prompts[5][12:]])
    return prompts


def run_case(cfg, params, prompts: Sequence[np.ndarray], max_new: int,
             device, tp=None, **kw) -> Dict[str, Any]:
    """One engine over ``prompts`` (all submitted at once): its outputs,
    stats, rank 0's pool bytes and wall seconds."""
    from ..serve.engine import ServeEngine
    t0 = time.perf_counter()
    with ServeEngine(cfg, params, tp=tp, device=device, **kw) as eng:
        outs = eng.generate(list(prompts), max_new=max_new)
        stats = dict(eng.stats)
        pool = eng._pkv.numel() * eng._pkv.element_size() \
            if eng.paged else 0
    return {"outs": outs, "stats": stats, "pool_bytes": pool,
            "seconds": time.perf_counter() - t0}


def parity_matrix(tp, cfg, params, prompts, max_new: int, device,
                  cases=MATRIX, **kw) -> Dict[str, Any]:
    """The single-device engine and the TP engine (rank 0 of ``tp``) on
    the same prompts for each ``(async_decode, prefix_cache)`` case.
    Returns ``{"single": run, "cases": {"async=..,prefix=..": run +
    "equal", "first_diff", "counters"}}``; raises nothing on a mismatch
    (the callers assert)."""
    kw = {**PARITY_KW, **kw}
    single = run_case(cfg, params, prompts, max_new, device, **kw)
    out = {"single": single, "cases": {}}
    for async_decode, prefix in cases:
        tp.reset_counters()
        run = run_case(cfg, params, prompts, max_new, device, tp=tp,
                       async_decode=async_decode, prefix_cache=prefix, **kw)
        diff = [i for i, (a, b) in enumerate(zip(single["outs"],
                                                 run["outs"]))
                if not np.array_equal(a, b)]
        run.update(equal=not diff, first_diff=diff[0] if diff else None,
                   counters=tp.counters())
        out["cases"][f"async={async_decode},prefix={prefix}"] = run
    return out


def probe_logits(cfg, params, tp, tokens: torch.Tensor) -> torch.Tensor:
    """The last-position prefill logits of ``tokens`` on this rank's shard
    of ``params`` (every rank of ``tp`` calls it; the result is the same
    on each)."""
    from ..distributed.sharding import shard_serve_params
    from ..models import lm
    shard = shard_serve_params(cfg, params, tp.rank, tp.world)
    with torch.inference_mode(), tp.active("probe"):
        logits, _ = lm.prefill(cfg, shard, tokens.to(tp.device))
    return logits


@dataclasses.dataclass(frozen=True)
class ProbeThenFollow:
    """A follower's body (picklable): :func:`probe_logits` on ``tokens``,
    then follow rank 0's engines."""
    tokens: Tuple[Tuple[int, ...], ...]

    def __call__(self, cfg, params, tp) -> list:
        from ..serve.tp import follow_engines
        probe_logits(cfg, params, tp,
                     torch.tensor(self.tokens, dtype=torch.int32))
        return follow_engines(cfg, params, tp)


@dataclasses.dataclass(frozen=True)
class FollowEach:
    """A follower's body (picklable): follow rank 0's engines on the
    session's model, then, each time rank 0 releases the followers, build
    the next of ``specs`` (:class:`repro_torch.launch.mesh.ModelSpec`) and
    follow the engines on it. Rank 0 calls ``release_followers`` once
    per model, the session's exit the last time. ``probe``: if given, the
    follower first joins :func:`probe_logits` on these tokens for each
    model of ``specs`` (rank 0 calls it there too), and its result is
    ``{"engines": [...], "allow_bf16_reduced_precision_reduction": its
    cuBLAS setting}``."""
    specs: Tuple[Any, ...]
    probe: Tuple[Tuple[int, ...], ...] = ()

    def __call__(self, cfg, params, tp):
        from ..serve.tp import follow_engines
        out = [follow_engines(cfg, params, tp)]
        for spec in self.specs:
            del params
            cfg, params = spec(tp.device)
            if self.probe:
                probe_logits(cfg, params, tp,
                             torch.tensor(self.probe, dtype=torch.int32))
            out.append(follow_engines(cfg, params, tp))
        if not self.probe:
            return out
        return {"engines": out, "allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction}


_MATMULS = (torch.Tensor.__matmul__, torch.Tensor.matmul,
            torch._C.TensorBase.matmul, torch.matmul)


class ColumnSlices(torch.Tensor):
    """A weight whose products ``x @ w`` are computed in ``parts``
    contiguous column slices, concatenated (``parts`` is the subclass's,
    :func:`column_slice_params` makes one per rank count). Every other
    operation (indexing, ``unbind``, ``.to``) keeps the wrapper.
    ``sliced`` counts the products computed so, on each subclass."""
    parts = 1
    sliced = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in _MATMULS and \
                len(args) == 2 and not kwargs and \
                isinstance(args[1], ColumnSlices) and \
                not isinstance(args[0], ColumnSlices):
            with torch._C.DisableTorchFunctionSubclass():
                x = args[0]
                w = args[1].as_subclass(torch.Tensor)
                n = w.shape[-1] // cls.parts
                cls.sliced += 1
                return torch.cat([x @ w[..., i * n:(i + 1) * n].contiguous()
                                  for i in range(cls.parts)], dim=-1)
        return super().__torch_function__(func, types, args, kwargs or {})


def column_slice_params(cfg, params: Dict[str, Any], world: int
                        ) -> Dict[str, Any]:
    """``params`` (shared, not copied) with the ``blocks`` weight matrices
    that :func:`repro_torch.distributed.shard_serve_params` cuts for
    ``world`` ranks wrapped in :class:`ColumnSlices` of ``world`` parts:
    a single-device engine on them computes each such product as the
    ranks do, slice by slice, and concatenates the slices as their
    all-gathers do."""
    from ..distributed.sharding import (SERVE_ATTN_LEAVES, SERVE_MLP_LEAVES,
                                        serve_attn_sharded,
                                        serve_mlp_sharded)
    cls = type(f"ColumnSlices{world}", (ColumnSlices,), {"parts": world})
    attn_ok = serve_attn_sharded(cfg, world)
    mlp_ok = serve_mlp_sharded(cfg, world)

    def wrap(name: str, t: torch.Tensor) -> torch.Tensor:
        if t.dim() >= 3 and ((attn_ok and name in SERVE_ATTN_LEAVES)
                             or (mlp_ok and name in SERVE_MLP_LEAVES)):
            return t.as_subclass(cls)
        return t

    out = dict(params)
    out["blocks"] = {k: wrap(k, v) for k, v in params["blocks"].items()}
    return out


def bench_mesh(quick: bool = False, mesh_model: int = 2, device=None,
               backend: str = "gloo") -> Iterator[Tuple[str, str, str]]:
    """The reference's ``serve_mesh`` rows: an ``mesh_model``-rank engine
    (ranks spawned here, ``backend``) against the single-device engine
    over one seeded Poisson trace, on the reference's widened smoke config
    (KV 4, H 8). Greedy tokens must be equal (asserted: the suite doubles
    as a parity gate)."""
    from ..device import resolve_device
    from ..launch.mesh import ModelSpec, TPSession
    from ..serve.engine import ServeEngine
    from .serve_continuous import _sample_lens, _trace

    dev = resolve_device(device)
    spec = ModelSpec(overrides=(("num_heads", 8), ("num_kv_heads", 4)))
    cfg, params = spec(dev)
    n_req = 8 if quick else 16
    max_new = 8 if quick else 24
    chunk = 4 if quick else 8
    rate = 200.0 if quick else 40.0
    bs = 8
    kv_blocks = 64 if quick else 128
    rng = np.random.default_rng(0)
    sizes = _sample_lens(rng, n_req, "choice", quick)
    trace = _trace(rng, sizes, rate, max_new)
    total_tokens = n_req * max_new
    max_seq = -(-(int(sizes.max()) + max_new) // bs) * bs

    def _run(tp):
        with ServeEngine(cfg, params, tp=tp, decode_chunk=chunk,
                         block_size=bs, max_seq_len=max_seq,
                         kv_blocks=kv_blocks, prefill_chunk=2 * bs,
                         device=dev) as eng:
            # one saturating burst runs every shape the trace hits
            eng.generate([p for _, p, _ in trace], max_new=chunk + 1)
            for k in eng.stats:
                eng.stats[k] = 0
            pool_dev = eng._pkv.numel() * eng._pkv.element_size()
            t0 = time.perf_counter()
            reqs = []
            for at, prompt, mn in trace:
                now = time.perf_counter() - t0
                if now < at:
                    time.sleep(at - now)
                reqs.append(eng.submit(prompt, mn))
            outs = [eng.result(r, timeout=600.0) for r in reqs]
            lat = [r.finished_at - t0 - at
                   for (at, _, _), r in zip(trace, reqs)]
            dt = time.perf_counter() - t0
            stats = dict(eng.stats)
        return dict(dt=dt, outs=outs, lat=lat, pool_dev=pool_dev,
                    stats=stats)

    single = _run(None)
    with TPSession(mesh_model, backend, spec, dev) as s:
        mesh = _run(s.tp)
        counters = s.tp.counters()
    mismatch = [i for i, (a, b) in
                enumerate(zip(single["outs"], mesh["outs"]))
                if not np.array_equal(a, b)]
    if mismatch:
        raise RuntimeError(
            f"mesh decode diverged from single-device on requests "
            f"{mismatch}: the all-gather-only TP path must be exact "
            "(greedy)")
    p50s, p99s = np.percentile(single["lat"], [50, 99])
    p50m, p99m = np.percentile(mesh["lat"], [50, 99])
    ratio = single["pool_dev"] / max(1, mesh["pool_dev"])
    # admission capacity at a fixed per-rank byte budget: with each
    # block's per-rank slice 1/N the size, N-fold the blocks fit in the
    # bytes one device spends on the whole pool
    blk_dev = mesh["pool_dev"] / kv_blocks
    capacity = int(single["pool_dev"] // blk_dev)
    where = f"{backend}_{dev.type}"
    yield ("serve_mesh_model_axis", str(mesh_model), f"ranks_{where}")
    yield ("serve_mesh_parity", "exact",
           f"{n_req}_requests_vs_single_device")
    yield ("serve_mesh_tok_per_s", f"{total_tokens/mesh['dt']:.1f}",
           f"{single['dt']/mesh['dt']:.2f}x_single")
    yield ("serve_mesh_single_tok_per_s",
           f"{total_tokens/single['dt']:.1f}", "")
    yield ("serve_mesh_p50_ms", f"{p50m*1e3:.0f}",
           f"single_{p50s*1e3:.0f}ms")
    yield ("serve_mesh_p99_ms", f"{p99m*1e3:.0f}",
           f"single_{p99s*1e3:.0f}ms")
    yield ("serve_mesh_pool_device_bytes", str(mesh["pool_dev"]),
           f"{ratio:.1f}x_smaller_than_single")
    yield ("serve_mesh_pool_full_bytes", str(single["pool_dev"]),
           f"{kv_blocks}_blocks")
    yield ("serve_mesh_capacity_blocks", str(capacity),
           f"vs_{kv_blocks}_at_fixed_device_bytes")
    yield ("serve_mesh_growth", str(mesh["stats"]["grown_blocks"]),
           f"{mesh['stats']['prefill_windows']}_windows_"
           f"{mesh['stats']['preempted']}_preemptions")
    yield ("serve_mesh_all_reduces",
           str(counters["calls"].get("all_reduce", 0)),
           f"{counters['calls'].get('all_gather', 0)}_all_gathers")
    yield ("serve_mesh_chunk_max_gather_bytes",
           str(counters["max_bytes"].get("all_gather:chunk", 0)),
           f"pool_shard_{mesh['pool_dev']}_bytes")

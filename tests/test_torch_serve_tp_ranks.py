"""What the spawned ranks of ``tests/test_torch_serve_tp.py`` run (it
holds no test). It imports neither JAX nor the JAX package, so a spawned
rank starts on torch and the port alone."""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch.mesh import mesh_ctx, small_mesh
from repro_torch.params import from_reference
from repro_torch.train.elastic import reshard_state
from repro_torch.train.train_step import make_decode_step, make_prefill_step

#: prompt tokens a row, and greedy decode steps after the prefill
S, STEPS = 12, 4
#: the MoE cases' capacity factor: the global batch's 48 tokens give an
#: expert 8 slots for its ~12 assignments, so tokens drop, and a rank
#: that routed its own 24 alone would keep more of them
LOW_CAP = (("capacity_factor", 0.5),)
#: (arch, (data, model), batch rows, config overrides)
CASES = [
    ("stablelm-1.6b", (1, 2), 4, ()),
    ("stablelm-1.6b", (2, 2), 4, ()),
    # 4 does not divide the 2 KV heads: each rank projects the one its
    # query head reads, and the first of the two holders sends it
    ("stablelm-1.6b", (1, 4), 4, ()),
    # one row: dp does not divide it, S lies over (data, model)
    ("stablelm-1.6b", (2, 2), 1, ()),
    # the serve steps' MoE routing over the global batch (no model axis)
    ("qwen2-moe-a2.7b", (2, 1), 4, LOW_CAP),
    ("qwen2-moe-a2.7b", (2, 2), 4, LOW_CAP),
    ("falcon-mamba-7b", (1, 2), 4, ()),
    ("zamba2-1.2b", (1, 2), 4, ()),
    # 4 does not divide 14 query heads: attention whole on every rank
    ("internvl2-1b", (1, 4), 4, (("num_heads", 14),)),
]


def case_id(case):
    arch, (d, m), B, over = case
    return f"{arch}-{d}x{m}-B{B}" + "".join(f"-{k}{v}" for k, v in over)


def ref_key(case):
    """The key of the case's single-device reference run (its arch, batch
    and overrides; the mesh does not change it)."""
    return case[0], case[2], case[3]


def cfg_of(arch, over=()):
    return dataclasses.replace(get_config(arch).smoke(),
                               compute_dtype="float32", **dict(over))


def frames(cfg):
    return cfg.frontend_tokens if cfg.frontend != "none" else 0


def max_len_of(cfg):
    """The cache's positions: the frames, the prompt and the decode steps,
    rounded up to a multiple of 4 (every case's sequence-parallel size
    divides it)."""
    return -(-(frames(cfg) + S + STEPS) // 4) * 4


def batch_of(case):
    """The case's prompts as numpy arrays: tokens, and a frontend arch's
    frames (standard normal, from their own seed)."""
    cfg = cfg_of(case[0], case[3])
    B = case[2]
    out = {"tokens": np.random.default_rng(1).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)}
    if frames(cfg):
        out["frontend_embeds"] = np.random.default_rng(2).standard_normal(
            (B, frames(cfg), cfg.d_model), dtype=np.float32)
    return out


def shapes_of(case):
    cfg = cfg_of(case[0], case[3])
    return (ShapeSpec("p", S, case[2], "prefill"),
            ShapeSpec("d", max_len_of(cfg), case[2], "decode"))


def cache_numpy(cache):
    """A cache's tensor leaves as numpy, by ``name.i`` (tuples unrolled)."""
    out = {}
    for k, v in cache.items():
        if k != "pos":
            for i, t in enumerate(v if isinstance(v, tuple) else (v,)):
                out[f"{k}.{i}"] = t.numpy().copy()
    return out


@dataclasses.dataclass(frozen=True)
class Body:
    """Every rank's work (picklable): each case's prefill step and its
    greedy decode steps on its mesh, from the reference's weights. A
    rank's results: its rows' logits and tokens, its cache blocks after
    the prefill and after the last step, and its group's collectives of
    each step."""
    trees: dict

    def __call__(self, dev):
        import torch.distributed as dist
        if dist.get_rank() != 0:
            os.nice(10)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            ctxs, out = {}, {}
            for case in CASES:
                mesh = case[1]
                if mesh not in ctxs:
                    ctxs[mesh] = mesh_ctx(small_mesh(*mesh), dev,
                                          timeout_s=60.0)
                if ctxs[mesh] is not None:
                    out[case_id(case)] = _port_case(
                        self.trees[ref_key(case)], case, ctxs[mesh])
            return out
        finally:
            torch.set_num_threads(threads)


def _port_case(tree, case, ctx):
    arch, _, B, over = case
    cfg = cfg_of(arch, over)
    full = from_reference(tree, cfg, device=ctx.group.device, cast=True)
    params = reshard_state(cfg, {"params": full}, ctx)["params"]
    pshape, dshape = shapes_of(case)
    group = ctx.group
    prefill, _, _ = make_prefill_step(cfg, ctx, pshape,
                                      max_len=max_len_of(cfg))
    decode, _, _ = make_decode_step(cfg, ctx, dshape)
    batch = {k: torch.from_numpy(v) for k, v in batch_of(case).items()}
    group.reset_counters()
    logits, cache = prefill(params, batch)
    counters = {"prefill": group.counters(), "decode": []}
    res = {"prefill_logits": logits.numpy().copy(),
           "cache0": cache_numpy(cache), "logits": []}
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    toks = [tok]
    rows = slice(0, B) if tok.shape[0] == B else \
        slice(ctx.mesh.axis_index(("data",), group.rank) * tok.shape[0],
              (ctx.mesh.axis_index(("data",), group.rank) + 1)
              * tok.shape[0])
    for _ in range(STEPS):
        # the step reads this rank's rows of the global tokens only
        glob = torch.zeros((B,), dtype=torch.int32)
        glob[rows] = tok
        group.reset_counters()
        logits, cache = decode(params, cache, glob)
        counters["decode"].append(group.counters())
        res["logits"].append(logits.numpy().copy())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
    res.update(tokens=torch.stack(toks, dim=1).numpy(), rows=(rows.start,
                                                            rows.stop),
               cache=cache_numpy(cache), pos=int(cache["pos"]),
               counters=counters)
    return res

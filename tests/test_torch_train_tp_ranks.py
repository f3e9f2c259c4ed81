"""What the spawned ranks of ``tests/test_torch_train_tp.py`` run (it
holds no test). It imports neither JAX nor the JAX package, so a spawned
rank starts on torch and the port alone."""
import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import mesh_ctx, small_mesh
from repro_torch.optim import OptConfig, init_error_state, init_opt_state
from repro_torch.params import from_reference
from repro_torch.train import CheckpointManager
from repro_torch.train.elastic import reshard_state
from repro_torch.train.train_step import (make_train_step, opt_shardings,
                                          param_shardings)
from repro_torch.tree import leaves

B, S = 4, 32
LR = 1e-3
#: (arch, (data, model), hoist the weight gather, microbatches, compress,
#: config overrides)
CASES = [
    ("stablelm-1.6b", (1, 2), False, None, False, ()),
    ("stablelm-1.6b", (1, 2), False, 2, False, ()),
    ("stablelm-1.6b", (1, 2), True, 2, False, ()),
    ("stablelm-1.6b", (1, 2), False, None, True, ()),
    ("stablelm-1.6b", (2, 2), False, None, False, ()),
    ("stablelm-1.6b", (2, 2), True, 2, False, ()),
    # tp = 4 does not divide the 2 KV heads: wk/wv come whole
    ("stablelm-1.6b", (1, 4), False, 1, False, ()),
    ("falcon-mamba-7b", (1, 2), False, None, False, ()),
    ("falcon-mamba-7b", (1, 2), True, 2, False, ()),
    ("qwen2-moe-a2.7b", (2, 1), False, None, False, ()),
    # split by expert (4 of 8 a rank), the aux loss weighted 1.0: an aux
    # gradient counted tp times, or a gate gradient of one rank's experts
    # only, moves the router beyond the bounds
    ("qwen2-moe-a2.7b", (1, 2), False, 1, False,
     (("router_aux_weight", 1.0),)),
    # the global batch's routing and the expert split together
    ("qwen2-moe-a2.7b", (2, 2), True, 2, False, ()),
    # 2 does not divide 5 experts: the hidden-dim split
    ("qwen2-moe-a2.7b", (1, 2), False, 1, False, (("num_experts", 5),)),
    # 6 experts and 2 inert ones, 2 a rank: the inert on the last rank;
    # 4 does not divide the 2 KV heads
    ("qwen2-moe-a2.7b", (1, 4), False, 1, False,
     (("num_experts", 6), ("moe_expert_pad", 2))),
    # the dense residual in parallel; fp32 masters: with its bf16 ones the
    # gradients are bf16 too, and where two summation orders differ a
    # gradient rounds to another bf16 (moments 1e-3 to 2e-3 of a leaf's
    # largest apart from one device's step, beyond the 1e-5 bound)
    ("arctic-480b", (1, 2), False, 1, False, (("param_dtype", "float32"),)),
    # its own bf16 masters, held to the hoisted bounds (BF16_MASTERS)
    ("arctic-480b", (1, 2), False, 1, False, ()),
    # Mamba2 on its heads, the shared block's fused_proj gathered; on
    # (1, 4) in_proj's 74-column blocks mix z, x, B, C and dt
    ("zamba2-1.2b", (1, 2), False, None, False, ()),
    ("zamba2-1.2b", (1, 4), False, 1, False, ()),
    ("zamba2-1.2b", (2, 2), True, 2, False, ()),
    # 4 does not divide 14 query heads: attention whole on every rank, the
    # MLP, embedding, head and loss partitioned
    ("internvl2-1b", (1, 4), False, 1, False, (("num_heads", 14),)),
    # 4 does not divide an MLP width of 90: the MLP whole on every rank
    # (the rule table keeps wi/wg/wd off the model axis), the rest cut
    ("stablelm-1.6b", (1, 4), False, 1, False, (("d_ff", 90),)),
]
#: the case whose final state a checkpoint saves and restores
SAVED = 0


def case_id(case):
    arch, (d, m), hoist, mb, comp, over = case
    return f"{arch}-{d}x{m}-hoist{int(hoist)}-mb{mb}" + (
        "-compress" if comp else "") + "".join(f"-{k}{v}" for k, v in over)


def tree_key(case):
    """The key of the case's initial weights (its arch and overrides)."""
    return case[0], case[5]


def cfg_of(arch, hoist=False, over=()):
    return dataclasses.replace(get_config(arch).smoke(),
                               compute_dtype="float32",
                               hoist_weight_gather=hoist, **dict(over))


def opt_of():
    return OptConfig(lr=LR, warmup_steps=0, total_steps=10)


def tokens(arch):
    return np.random.default_rng(1).integers(
        0, cfg_of(arch).vocab_size, (B, S)).astype(np.int32)


def batch_of(case):
    """The case's global batch as numpy arrays: its tokens, and a frontend
    arch's frames (standard normal, from their own seed)."""
    cfg = cfg_of(case[0], over=case[5])
    out = {"tokens": tokens(case[0])}
    if cfg.frontend != "none":
        out["frontend_embeds"] = np.random.default_rng(2).standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model), dtype=np.float32)
    return out


def to_numpy(x):
    """``x`` as numpy; a bf16 tensor in fp32 (exact)."""
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def torch_batch(case):
    return {k: torch.from_numpy(v) for k, v in batch_of(case).items()}


@dataclasses.dataclass(frozen=True)
class Body:
    """Every rank's work (picklable): each case's step on its mesh, and a
    checkpoint of the first case's state. Rank 0's results carry the whole
    state; every rank's its counters and its replicated leaves."""
    trees: dict
    ckpt_root: str

    def __call__(self, dev):
        import torch.distributed as dist
        if dist.get_rank() != 0:
            os.nice(10)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return self._run(dev)
        finally:
            torch.set_num_threads(threads)

    def _run(self, dev):
        ctxs, out = {}, {}
        for i, case in enumerate(CASES):
            shape = case[1]
            if shape not in ctxs:
                ctxs[shape] = mesh_ctx(small_mesh(*shape), dev,
                                       timeout_s=60.0)
            ctx = ctxs[shape]
            if ctx is not None:
                out[case_id(case)] = _port_case(
                    self.trees[tree_key(case)], case, ctx,
                    Path(self.ckpt_root) / "ckpt" if i == SAVED else None)
        return out


def _paths(tree, prefix=""):
    """The '/'-joined key path of every leaf, in leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _port_case(tree, case, ctx, ckpt):
    arch, _, hoist, mb, comp, over = case
    cfg = cfg_of(arch, hoist, over)
    full = from_reference(tree, cfg, device=ctx.group.device, cast=False)
    params = reshard_state(cfg, {"params": full}, ctx)["params"]
    st = init_opt_state(params, opt_of())
    if comp:
        st["err"] = init_error_state(params)
    step = make_train_step(cfg, opt_of(), compress=comp, microbatches=mb,
                           ctx=ctx)
    ctx.group.reset_counters()
    params, st, met = step(params, st, torch_batch(case))
    counters = ctx.group.counters()
    pshard = param_shardings(cfg, ctx)
    sh = leaves(pshard)
    res = {"metrics": {k: float(v) for k, v in met.items()},
           "counters": counters,
           "shapes": {n: tuple(x.shape) for n, x in
                      zip(_paths(params), leaves(params))},
           # the leaves no spec shards over the model axis, as this rank
           # holds them: every model rank must hold the same
           "replicated": {i: to_numpy(x).copy() for i, (x, s) in
                          enumerate(zip(leaves(params), sh))
                          if "model" not in str(s.spec)}}
    whole = {}
    for what, t in (("params", params), ("m", st["m"]), ("v", st["v"])):
        whole[what] = [to_numpy(ctx.group.gather_leaf(x, s.spec))
                       for x, s in zip(leaves(t), sh)]
    if ctx.group.rank == 0:
        res.update(whole)
    if ckpt is not None:
        oshard = opt_shardings(cfg, ctx, pshard)
        CheckpointManager(str(ckpt)).save_sharded(
            1, {"params": params, "opt": {k: st[k] for k in
                                          ("m", "v", "count")}},
            {"params": pshard, "opt": oshard}, ctx.group)
    return res

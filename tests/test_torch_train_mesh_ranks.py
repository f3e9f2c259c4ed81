"""What the spawned ranks of ``tests/test_torch_train_mesh.py`` run (it
holds no test). It imports neither JAX nor the JAX package, so a spawned
rank starts on torch and the port alone: the module's group shares the
host with the other test workers, whose timing-bound tests a burst of
heavy imports in three children would slow."""
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import mesh_ctx, small_mesh
from repro_torch.optim import OptConfig, init_error_state, init_opt_state
from repro_torch.params import from_reference
from repro_torch.train import CheckpointManager, Trainer, TrainerConfig
from repro_torch.train.elastic import reshard_state
from repro_torch.train.train_step import (make_train_step, opt_shardings,
                                          param_shapes, param_shardings)
from repro_torch.tree import leaves, tree_map

CPU = torch.device("cpu")
ARCH = "stablelm-1.6b"
B, S = 8, 32
LR = 1e-3
#: (data, model), hoist the weight gather, microbatches, compress
CASES = [
    ((1, 1), False, None, False),
    ((2, 1), False, None, False),
    ((2, 1), False, 1, False),
    ((2, 1), False, 2, False),
    ((2, 1), True, 2, False),
    ((4, 1), False, None, False),
    ((4, 1), True, None, False),
    ((2, 2), False, 2, False),
    ((2, 2), True, None, False),
    ((2, 1), False, None, True),
    ((2, 2), False, 1, True),
]
TRAIN_TC = dict(total_steps=4, ckpt_every=2, log_every=1, microbatches=None)
TRAIN_BS = (4, 32)


def case_id(case):
    (d, m), hoist, mb, comp = case
    return f"{d}x{m}-hoist{int(hoist)}-mb{mb}" + ("-compress" if comp
                                                  else "")


def cfg_of(hoist=False):
    return dataclasses.replace(get_config(ARCH).smoke(),
                               compute_dtype="float32",
                               hoist_weight_gather=hoist)


def opt_of():
    return OptConfig(lr=LR, warmup_steps=0, total_steps=10)


def tokens():
    return np.random.default_rng(1).integers(
        0, cfg_of().vocab_size, (B, S)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class Body:
    """Every rank's work (picklable): the step cases, the elastic
    restores and saves, the 2-rank trainer. Rank 0's result carries the
    whole tensors; every rank's its state bytes."""
    tree: dict
    toks: np.ndarray
    ckpt_root: str

    def __call__(self, dev):
        import torch.distributed as dist
        if dist.get_rank() != 0:      # a spawned rank: see _start_reference
            os.nice(10)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)      # 4 ranks and the reference share
        try:                          # the CPU with the other workers
            return self._run(dev)
        finally:
            torch.set_num_threads(threads)

    def _run(self, dev):
        ctxs = {}

        def ctx_of(shape):
            if shape not in ctxs:
                ctxs[shape] = mesh_ctx(small_mesh(*shape), dev,
                                       timeout_s=60.0)
            return ctxs[shape]

        out = {"steps": {}, "bytes": {}, "elastic": {}}
        for case in CASES:
            if case[0] == (1, 1):
                continue
            ctx = ctx_of(case[0])
            if ctx is None:
                continue
            out["steps"][case_id(case)], out["bytes"][case_id(case)] = \
                _port_case(self.tree, self.toks, case, ctx)
        out["elastic"] = _elastic(ctx_of, Path(self.ckpt_root))
        out["trainer"] = _trainers(ctx_of((2, 1)), Path(self.ckpt_root))
        out["counters"] = {str(k): v.group.counters()
                           for k, v in ctxs.items() if v is not None}
        return out


def state_bytes(tree):
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _spec_bytes(cfg, ctx, params):
    """What the specs give: each leaf's block bytes for this rank."""
    sh = leaves(param_shardings(cfg, ctx))
    return sum(s.nbytes(t.shape, t.dtype) for s, t in
               zip(sh, leaves(params)))


def _port_case(tree, toks, case, ctx):
    (_, _), hoist, mb, comp = case
    cfg = cfg_of(hoist)
    full = from_reference(tree, cfg, device=ctx.group.device, cast=False)
    params = reshard_state(cfg, {"params": full}, ctx)["params"]
    st = init_opt_state(params, opt_of())
    if comp:
        st["err"] = init_error_state(params)
    local_bytes = {"params": state_bytes(params),
                   "moments": state_bytes(st["m"]) + state_bytes(st["v"]),
                   "spec": _spec_bytes(cfg, ctx, full),
                   "full": state_bytes(full)}
    step = make_train_step(cfg, opt_of(), compress=comp, microbatches=mb,
                           ctx=ctx)
    ctx.group.reset_counters()
    params, st, met = step(params, st, {"tokens": torch.from_numpy(toks)})
    counters = ctx.group.counters()
    sh = leaves(param_shardings(cfg, ctx))
    whole = {}
    for what, t in (("params", params), ("m", st["m"]), ("v", st["v"])):
        whole[what] = [ctx.group.gather_leaf(x, s.spec).numpy()
                       for x, s in zip(leaves(t), sh)]
    res = {"metrics": {k: float(v) for k, v in met.items()},
           "counters": counters}
    if ctx.group.rank == 0:
        res.update(whole)
    return res, local_bytes


def full_state(cfg, tree):
    params = from_reference(tree, cfg, device=CPU, cast=False)
    st = init_opt_state(params, opt_of())
    # moments that are not zero, so a misplaced block would show
    g = torch.Generator().manual_seed(3)
    st["m"] = tree_map(lambda t: torch.randn(t.shape, generator=g), params)
    st["v"] = tree_map(lambda t: torch.rand(t.shape, generator=g), params)
    st["count"] = torch.tensor(7, dtype=torch.int32)
    return {"params": params, "opt": st}


def _elastic(ctx_of, root):
    """Restore the 1-rank save at 2 and 4 ranks (each block checked here
    against the block of the whole state), save there, then restore the
    2-rank save at 4 ranks and the 4-rank save at 2."""
    cfg = cfg_of()
    res = {}
    for shape, src, dst in (((2, 1), "ckpt1", "ckpt2"),
                            ((4, 1), "ckpt1", "ckpt4"),
                            ((4, 1), "ckpt2", "ckpt2to4"),
                            ((2, 1), "ckpt4", "ckpt4to2")):
        ctx = ctx_of(shape)
        if ctx is None:
            continue
        whole = json.loads((root / "whole.json").read_text())
        full = CheckpointManager(str(root / "ckpt1")).restore(
            whole["step"], _example(cfg), CPU)
        pshard = param_shardings(cfg, ctx)
        shard = {"params": pshard, "opt": opt_shardings(cfg, ctx, pshard)}
        want = reshard_state(cfg, full, ctx)
        mgr = CheckpointManager(str(root / src))
        step = mgr.latest_step()
        got = mgr.restore(step, want, CPU, shard)
        same = all(torch.equal(a, b) for a, b in
                   zip(leaves(got), leaves(want)))
        CheckpointManager(str(root / dst)).save_sharded(step, got, shard,
                                                        ctx.group)
        res[f"{src}->{dst}"] = {"equal": same,
                                "bytes": state_bytes(got)}
    return res


def _example(cfg):
    """A whole state of ``cfg``'s shapes (the structure restore fills)."""
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                      param_shapes(cfg))
    return {"params": params, "opt": init_opt_state(params, opt_of())}


def trainer_run(cfg, ctx, root, tag, fail_at):
    tc = TrainerConfig(**TRAIN_TC, fail_at_step=fail_at)
    tr = Trainer(cfg, tc, *TRAIN_BS, opt=OptConfig(lr=LR, warmup_steps=1,
                                                   total_steps=4),
                 ckpt_dir=str(root / tag), device=CPU, ctx=ctx)
    out = tr.run()
    st = out["state"]
    res = {"restarts": out["restarts"], "step": st["step"],
           "history": out["history"]}
    if ctx is not None:
        sh = leaves(param_shardings(cfg, ctx))
        res["params"] = [ctx.group.gather_leaf(x, s.spec).numpy()
                         for x, s in zip(leaves(st["params"]), sh)]
        res["steps_saved"] = CheckpointManager(str(root / tag)).all_steps()
    else:
        res["params"] = [x.numpy() for x in leaves(st["params"])]
    return res


def _trainers(ctx, root):
    if ctx is None:
        return None
    cfg = get_config(ARCH).smoke()
    return {"plain": trainer_run(cfg, ctx, root, "tr_plain", None),
            "restarted": trainer_run(cfg, ctx, root, "tr_fail", 3)}


def fail_on_rank_one(dev):
    import torch.distributed as dist
    if dist.get_rank() == 1:
        return 1 // 0
    return None


def fail_then_reduce(dev):
    import torch.distributed as dist
    if dist.get_rank() == 1:
        return 1 // 0
    dist.all_reduce(torch.ones(4))
    return None

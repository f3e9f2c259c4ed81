"""Train cells: the program's trainer (``repro_torch.train.trainer.
Trainer``: its cyclic task graph, its prefetcher and the train step with
AdamW) on the benchmark's weights and batches.

Set-up builds ONE trainer and its state (float32 masters made on the
device from the seed, zero moments) and hands the benchmark's state and
batches in through the instance's ``init_state`` and ``data.batch_at``
(the program is not edited). It drives that trainer from the seed
through its first steps, through the same ``Trainer.run`` the window
calls: after the first it reads the first gradient from the first moment,
after ``ref_steps`` the change of every leaf; the warm step times the
window. The window is ``round(--seconds / step)`` further steps of the
same trainer, timed whole. ``--trace 1`` traces ``trace_steps`` more
steps after the window.

Then the program's state is freed and the reference follows the first
``ref_steps`` steps (``perfbench/correct.py``).
"""
from __future__ import annotations

import gc
import time

import torch

from perfbench import correct, port, weights


def run(r) -> None:
    spec, dev, mix = r.spec, r.device, r.spec.mix
    ref, gen = spec.reference(), spec.generator()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    V = spec.conf["vocab_size"]
    pcfg = port.config(spec)
    shapes = ref.shapes(spec.conf)
    flat = weights.make(shapes, r.seed, dev, served=False, vocab=V)
    from repro_torch.core import ACCEL, HOST, Executor
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    opt = OptConfig(**mix["opt"])
    ex = Executor(domains={HOST: 2, ACCEL: 1}, devices={ACCEL: [dev]})
    warm = int(mix["warm_steps"])
    ref_steps = int(spec.cell.get("ref_steps", warm))
    tc = TrainerConfig(total_steps=1, ckpt_every=1 << 30, log_every=1,
                       microbatches=int(mix["microbatches"]), seed=0)
    tr = Trainer(pcfg, tc, batch=int(mix["batch"]),
                 seq_len=int(mix["seq_len"]), opt=opt, executor=ex,
                 device=dev)
    params = weights.tree(flat)
    state = {"params": params, "opt": init_opt_state(params, opt),
             "step": 0}
    tr.init_state = lambda: state
    tr.data.batch_at = lambda step: {
        "tokens": gen.batch(mix, V, r.seed, step)}
    tokens_per_step = int(mix["batch"]) * int(mix["seq_len"])
    prog = {}
    try:
        def steps_to(n: int, log_every: int = 1) -> float:
            tc.total_steps, tc.log_every = n, log_every
            t0 = time.perf_counter()
            tr.run()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter() - t0

        t_warm = 0.0
        for n in range(1, max(warm, ref_steps) + 1):
            t_warm = steps_to(n)
            if n == 1:
                prog["first_grad"] = {
                    k: float(t.float().norm()) / (1 - opt.b1)
                    for k, t in weights.flatten(state["opt"]["m"]).items()}
            if n == ref_steps:
                prog["change"] = correct.change_norms(
                    weights.flatten(state["params"]), shapes, r.seed, V)
        prog["losses"] = [h["loss"] for h in tr.history]
        done = state["step"]
        n_timed = max(1, round(r.seconds / max(t_warm, 1e-3)))
        r.setup_s = time.perf_counter() - r.t_start
        wall = steps_to(done + n_timed, log_every=1 << 30)
        r.window = (r.setup_s + r.t_start, r.setup_s + r.t_start + wall)
        r.steps = {"n": n_timed, "wall_s": wall, "tokens": tokens_per_step,
                   "losses": [h["loss"] for h in tr.history[-1:]]}
        if r.trace and dev.type == "cuda":
            from perfbench.trace import Profile
            Profile.warm(dev)
            prof = Profile(dev)
            k = int(mix["trace_steps"])
            prof.start()
            t0 = time.perf_counter()
            steps_to(done + n_timed + k, log_every=1 << 30)
            traced_wall = time.perf_counter() - t0
            prof.stop()
            r.profile = prof
            r.steps["traced"] = {"n": k, "wall_s": traced_wall}
    finally:
        ex.shutdown()
    r.attempted = r.steps["n"]
    r.failed = sum(not (v == v and abs(v) < float("inf"))
                   for v in r.steps["losses"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    # the executor's finished task graphs hold the step's closures, and
    # with them the state
    del state, params, flat, tr, ex
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    correct.train(r, prog, correct.reference_train(r, ref, ref_steps))

"""How ``correct`` is decided: what the timed path produced, held against
the plain reference (``perfbench/reference/<family>.py``, float32 with TF32
off), after the window has closed and the program's state is freed.

Serve cells: no request due in the window may be refused, failed or come
back malformed (``unserved``, limit 0); one still running when the wait
past the window's close ends is late, not wrong. From the seed, a sample
of the window's answers, the longest among them, of at least the mix's
``check_tokens`` served tokens: the reference runs once over each prompt
with its served tokens, and ``logit_gap`` is the widest gap by which a
served token's logit lies below the reference's best at its position.

Train cells: the window's trainer is driven from the seed through its
first steps in set-up; the reference follows them from the same weights
and batches. ``loss_gap``: the widest gap of a step's loss. ``grad_gap``:
the worst leaf's gap between the norms of the first gradient as the
optimizer takes it (the program's read from its first moment after one
step), against the reference's norm of that leaf or of the median leaf,
whichever is larger. ``change_gap``: the same for the norm of each leaf's
change over the steps, leaving out the leaves whose reference gradient is
under a thousandth of the median leaf's (they move under AdamW by
round-off alone).

The limits are the cell's (``cells/<cell>.json``, ``limits``), set from
readings of the program and of the control (``perfbench/control.py``).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import weights
from perfbench.reference.common import fp32_mode


def sample(done: List, seed: int, mix: Dict) -> List:
    """The longest answer (prompt and output) and others drawn from the
    seed, until the sample holds ``check_tokens`` served tokens or
    ``check_max_requests`` requests."""
    if not done:
        return []
    order = sorted(range(len(done)),
                   key=lambda i: -(done[i].prompt_len + done[i].n_out))
    pick = [order[0]]
    rest = list(weights.rng(seed, 4).permutation(order[1:]))
    while rest and len(pick) < mix["check_max_requests"] and \
            sum(done[i].n_out for i in pick) < mix["check_tokens"]:
        pick.append(int(rest.pop()))
    return [done[i] for i in pick]


def answer_gaps(conf, ref, flat, q, device, control: bool = False):
    """(the widest gap of the served tokens; with ``control``, the widest
    gap of the tokens the float8 reference puts first) over one answer."""
    V = conf["vocab_size"]
    seq = np.concatenate([q.prompt, q.tokens[:-1]]).astype(np.int64)
    seq = torch.from_numpy(seq).to(device)
    start = q.prompt_len - 1
    lg = ref.logits(conf, flat, seq, start, "fp32")[:, :V]
    best = lg.max(dim=-1).values
    rows = torch.arange(lg.shape[0], device=device)
    served = torch.from_numpy(q.tokens.astype(np.int64)).to(device)
    gap = float((best - lg[rows, served]).max())
    if not control:
        return gap, None
    pick = ref.logits(conf, flat, seq, start, "fp8")[:, :V].argmax(dim=-1)
    return gap, float((best - lg[rows, pick]).max())


def serve(r, ref, flat, control: bool = False) -> Dict:
    fp32_mode()
    window = [q for q in r.requests if q.phase == "window"]
    done = [q for q in window if q.ok]
    picked = sample(done, r.seed, r.mix)
    t0 = time.perf_counter()
    gap, ctl = 0.0, 0.0
    for q in picked:
        g, c = answer_gaps(r.conf, ref, flat, q, r.device, control)
        gap = max(gap, g)
        if c is not None:
            ctl = max(ctl, c)
    limits = r.cell.get("limits", {})
    bad = sum(q.error is not None for q in window)
    r.compared = {"unserved": (bad, 0),
                  "logit_gap": (gap, limits.get("logit_gap", 0.0))}
    r.notes.append(f"checked {len(picked)} answers, "
                   f"{sum(q.n_out for q in picked)} served tokens, in "
                   f"{time.perf_counter() - t0:.1f} s")
    return {"logit_gap": gap, "control_gap": ctl if control else None,
            "tokens": sum(q.n_out for q in picked)}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None
             ) -> float:
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def reference_train(r, ref, steps: int, precision: str = "fp32") -> Dict:
    """The reference's losses, first gradient norms and change norms over
    ``steps`` steps from the seed's weights and batches."""
    fp32_mode()
    conf, mix, dev = r.conf, r.mix, r.device
    V = conf["vocab_size"]
    gen = r.spec.generator()
    shapes = ref.shapes(conf)
    params = weights.make(shapes, r.seed, dev, served=False, vocab=V)
    batches = [torch.from_numpy(gen.batch(mix, V, r.seed, s)).to(dev)
               for s in range(steps)]
    from perfbench.reference.common import train
    losses, first = train(
        lambda w, mb: ref.loss(conf, w, mb, precision), params, batches,
        mix["opt"], mix["microbatches"])
    change = change_norms(params, shapes, r.seed, V)
    return {"losses": losses, "first_grad": first, "change": change}


def change_norms(params: Dict[str, torch.Tensor], shapes, seed: int,
                 vocab: int) -> Dict[str, float]:
    """Each leaf's norm of its change from the seed's initial weights
    (drawn again leaf by leaf)."""
    out = {}
    for n, t in params.items():
        shape, init, _ = shapes[n]
        p0 = weights.draw(shape, init, torch.float32, seed, n, t.device)
        weights.zero_padding({n: p0}, vocab)
        out[n] = float((t.float() - p0).norm())
        del p0
    return out


def train(r, prog: Dict, refd: Dict) -> None:
    """Hold the program's first steps (``prog``: losses, first_grad,
    change) against the reference's (``refd``)."""
    limits = r.cell.get("limits", {})
    k = len(refd["losses"])
    med = statistics.median(refd["first_grad"].values())
    keep = {n for n, g in refd["first_grad"].items() if g >= 1e-3 * med}
    r.compared = {
        "loss_gap": (max(abs(a - b) for a, b in
                         zip(prog["losses"][:k], refd["losses"])),
                     limits.get("loss_gap", 0.0)),
        "grad_gap": (leaf_gap(prog["first_grad"], refd["first_grad"]),
                     limits.get("grad_gap", 0.0)),
        "change_gap": (leaf_gap(prog["change"], refd["change"], keep),
                       limits.get("change_gap", 0.0)),
    }
    r.notes.append(f"reference followed {k} steps; losses program "
                   f"{prog['losses'][:k]} reference {refd['losses']}; "
                   f"{len(keep)} of {len(refd['first_grad'])} leaves in the "
                   "change")

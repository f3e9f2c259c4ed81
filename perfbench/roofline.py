"""The chip's peaks (``peaks.json``) and the least time a piece of work
could take on them: the largest of its bytes over the memory bandwidth,
its tensor-core (bfloat16) and float32 operations over their peaks, and
its exponentials over the special-function units' rate."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())


def least_time(nbytes: float = 0.0, bf16_flops: float = 0.0,
               fp32_flops: float = 0.0, exps: float = 0.0):
    """(seconds, what bounds it)."""
    terms = {"bytes": nbytes / PEAKS["hbm_bytes_per_s"],
             "bf16 operations": bf16_flops / PEAKS["bf16_flops_per_s"],
             "fp32 operations": fp32_flops / PEAKS["fp32_flops_per_s"],
             "exponentials": exps / PEAKS["exp_per_s"]}
    which = max(terms, key=terms.get)
    return terms[which], which


def share(run, name: str, kernels, work) -> float:
    """A kernel's share of its roofline over the traced span, in %: the
    least time of ``work`` (a dict of :func:`least_time`'s arguments)
    over the summed device time of ``kernels``; None where no such kernel
    ran or there is no work."""
    if run.profile is None:
        return None
    t, n = run.profile.kernel_s(kernels)
    if n == 0 or t <= 0:
        return None
    least, which = least_time(**work)
    if least <= 0:
        return None
    run.notes.append(f"{name}: {n} launches, {t:.6f} s on the device, "
                     f"least time {least:.6f} s ({which})")
    return 100.0 * least / t

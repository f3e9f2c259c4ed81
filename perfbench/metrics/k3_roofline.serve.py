"""K3, the selective scan (``mamba_scan_kernel``), against its roofline
over the traced span. Work: the scan of every prompt admitted in the span,
every layer: dt (fp32), x, B and C (bf16) read, y (fp32) and the final
state written, one exponential and three fp32 fused multiply-adds an
element-step of the (tokens, channels, state) scan."""
from perfbench import roofline, work


def read(run):
    if run.profile is None or run.steps is not None:
        return None
    d = run.spec.reference().dims(run.conf)
    if "N" not in d:
        return None
    a, b = work.span(run)
    L, dI, N = d["L"], d["dI"], d["N"]
    S = sum(q.prompt_len for q in work.admitted(run, a, b))
    n = len(work.admitted(run, a, b))
    nbytes = L * (S * dI * (4 + 2 + 4) + S * 2 * N * 2 + n * 2 * dI * N * 4)
    return roofline.share(run, "k3_roofline.serve", ["mamba_scan_kernel"],
                          {"nbytes": nbytes, "exps": L * S * dI * N,
                           "fp32_flops": L * 6 * S * dI * N})

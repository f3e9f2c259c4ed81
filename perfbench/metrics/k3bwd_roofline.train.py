"""K3's backward (``mamba_scan_bwd_kernel`` and ``mamba_scan_bwd_sum_kernel``)
against its roofline over the traced steps. Work: one backward scan of
every sequence in every layer: dt, dy (fp32), x, B, C (bf16) read, d dt
(fp32), dx, dB, dC (bf16) and dA written, one exponential and about eight
fp32 fused multiply-adds an element-step."""
from perfbench import roofline


def read(run):
    s = run.steps
    if s is None or "traced" not in s:
        return None
    d = run.spec.reference().dims(run.conf)
    if "N" not in d:
        return None
    L, dI, N = d["L"], d["dI"], d["N"]
    T = s["tokens"] * s["traced"]["n"]
    nbytes = L * (T * dI * (4 + 4 + 2 + 4 + 2) + T * 4 * N * 2)
    return roofline.share(run, "k3bwd_roofline.train",
                          ["mamba_scan_bwd_kernel",
                           "mamba_scan_bwd_sum_kernel"],
                          {"nbytes": nbytes, "exps": L * T * dI * N,
                           "fp32_flops": L * 16 * T * dI * N})

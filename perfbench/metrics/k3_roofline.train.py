"""K3's training entry (``mamba_scan_kernel``) against its roofline over
the traced steps. Work: one forward scan of every sequence in every layer
(a recomputation in the backward is not counted): dt (fp32), x, B and C
(bf16) read, y (fp32) written, one exponential and three fp32 fused
multiply-adds an element-step."""
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
    nbytes = L * (T * dI * (4 + 2 + 4) + T * 2 * N * 2)
    return roofline.share(run, "k3_roofline.train", ["mamba_scan_kernel"],
                          {"nbytes": nbytes, "exps": L * T * dI * N,
                           "fp32_flops": L * 6 * T * dI * N})

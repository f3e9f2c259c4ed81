"""K1, the paged decode attention (``paged_attention_kernel``), against
its roofline over the traced span. Work: every decode token produced in
the span reads the K and V of each key it attends (bf16) and its query and
writes its output, in every layer; 4 x heads x head width fp32
operations a key."""
from perfbench import roofline, work


def read(run):
    if run.profile is None or run.steps is not None:
        return None
    ref = run.spec.reference()
    d = ref.dims(run.conf)
    if "KV" not in d:
        return None
    a, b = work.span(run)
    keys = sum(k for _, k in work.decoded(run, a, b))
    n = sum(1 for _ in work.decoded(run, a, b))
    L, H, KV, hd = d["L"], d["H"], d["KV"], d["hd"]
    nbytes = L * (keys * 2 * KV * hd * 2 + n * 2 * H * hd * 2)
    return roofline.share(run, "k1_roofline.serve",
                          ["paged_attention_kernel"],
                          {"nbytes": nbytes,
                           "fp32_flops": L * 4 * H * hd * keys})

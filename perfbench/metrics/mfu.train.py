"""Model FLOPs of the window's steps by the PaLM count, 6 N + 12 L D S a
token (N the matrix weights a token passes, the LM head included; L the
attention layers; recomputation not counted), over the window's wall time
and the chip's bfloat16 peak, in %. The window's steps run untraced, so
the profiler's cost on the host's launches does not enter."""
from perfbench.roofline import PEAKS


def read(run):
    s = run.steps
    if s is None:
        return None
    f = run.spec.reference().model_flops_per_token(run.conf)
    S = run.mix["seq_len"]
    per_token = 6 * (f["body"] + f["head"]) \
        + 12 * f["attn_layers"] * f["d_model"] * S
    return 100.0 * per_token * s["tokens"] * s["n"] / s["wall_s"] \
        / PEAKS["bf16_flops_per_s"]

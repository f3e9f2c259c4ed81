"""The model FLOPs the traffic's tokens needed inside the traced span over
the span and the chip's bfloat16 peak, in %: 2 x the matrix weights a
token passes (the LM head for the tokens whose logits are served: each
answer's tokens, its first from the prompt's last position) and the
attention over each token's context (4 x heads x head width a key, every
attention layer)."""
from perfbench import work
from perfbench.roofline import PEAKS


def read(run):
    if run.profile is None or run.steps is not None:
        return None
    a, b = work.span(run)
    f = run.spec.reference().model_flops_per_token(run.conf)
    flops = 0.0
    for q, t in work.prefilled(run, a, b):
        flops += 2 * f["body"] + f["attn_per_key"] * (t + 1)
        if t == q.prompt_len - 1:
            flops += 2 * f["head"]
    for q, keys in work.decoded(run, a, b):
        flops += 2 * (f["body"] + f["head"]) + f["attn_per_key"] * keys
    if flops == 0:
        return None
    return 100.0 * flops / (b - a) / PEAKS["bf16_flops_per_s"]

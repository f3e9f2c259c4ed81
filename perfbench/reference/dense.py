"""Plain reference of a dense decoder, as the port runs stablelm-1.6b:
pre-norm RMSNorm layers, multi-head (or grouped) causal attention with
rotary embeddings over the whole head (half-split pairs), a SwiGLU MLP,
no biases, an untied LM head over the vocabulary padded to a multiple of
256. The departures from the published model are listed under
``assumed`` in the configuration's file; this file follows the equations
the configuration states. Widths come from the configuration's file, never
from the program.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.common import (checkpointed, logits_loss, mm,
                                        rms_norm, round_up)
from perfbench.weights import fan_in

#: query rows a block of the attention scores holds (float32 (H, rows, S))
Q_BLOCK = 1024


def dims(conf: Dict) -> Dict:
    D, H = conf["hidden_size"], conf["num_attention_heads"]
    return {"L": conf["num_hidden_layers"], "D": D, "H": H,
            "KV": conf["num_key_value_heads"],
            "hd": conf.get("head_dim") or D // H,
            "F": conf["intermediate_size"], "V": conf["vocab_size"],
            "Vp": round_up(conf["vocab_size"], 256),
            "theta": float(conf["rope_theta"]),
            "eps": float(conf["layer_norm_eps"])}


def shapes(conf: Dict) -> Dict[str, tuple]:
    """name -> (shape, init, matrix): the leaves in the port's layout."""
    d = dims(conf)
    L, D, H, KV, hd, Fd, Vp = (d["L"], d["D"], d["H"], d["KV"], d["hd"],
                               d["F"], d["Vp"])
    out = {"embed": ((Vp, D), ("normal", 0.02), True),
           "lm_head": ((D, Vp), ("normal", 0.02), True),
           "final_norm": ((D,), ("const", 1.0), False),
           "blocks.ln1": ((L, D), ("const", 1.0), False),
           "blocks.ln2": ((L, D), ("const", 1.0), False)}
    for name, shape in (("wq", (L, D, H * hd)), ("wk", (L, D, KV * hd)),
                        ("wv", (L, D, KV * hd)), ("wo", (L, H * hd, D)),
                        ("wi", (L, D, Fd)), ("wg", (L, D, Fd)),
                        ("wd", (L, Fd, D))):
        out["blocks." + name] = (shape, ("normal", fan_in(shape)), True)
    return out


def kv_bytes_per_token(conf: Dict) -> int:
    """Bytes of K and V a token keeps in a bfloat16 cache, all layers."""
    d = dims(conf)
    return 2 * d["L"] * d["KV"] * d["hd"] * 2


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) at positions 0..S-1; pairs (i, i + hd/2)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal softmax(q k^T / sqrt(hd)) v, float32; q (B, S, H, hd), k/v
    (B, S, KV, hd); query rows in blocks of Q_BLOCK."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2).transpose(1, 2)      # (B, H, S, hd)
    v = v.repeat_interleave(G, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for s0 in range(0, S, Q_BLOCK):
        qb = q[:, :, s0:s0 + Q_BLOCK]
        n = qb.shape[2]
        s = qb @ k[:, :, :s0 + n].transpose(-1, -2) * hd ** -0.5
        mask = torch.arange(s0 + n, device=q.device)[None, :] \
            <= torch.arange(s0, s0 + n, device=q.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v[:, :, :s0 + n])
    return torch.cat(outs, dim=2).transpose(1, 2)          # (B, S, H, hd)


def _layer(x, ln1, wq, wk, wv, wo, ln2, wi, wg, wd, d, precision):
    B, S, _ = x.shape
    h = rms_norm(x, ln1, d["eps"])
    q = mm(h, wq, precision).view(B, S, d["H"], d["hd"])
    k = mm(h, wk, precision).view(B, S, d["KV"], d["hd"])
    v = mm(h, wv, precision).view(B, S, d["KV"], d["hd"])
    o = _attention(_rope(q, d["theta"]), _rope(k, d["theta"]), v)
    x = x + mm(o.reshape(B, S, -1), wo, precision)
    h = rms_norm(x, ln2, d["eps"])
    a = mm(h, wg, precision)
    return x + mm(torch.nn.functional.silu(a) * mm(h, wi, precision), wd,
                  precision)


LAYER_LEAVES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wi", "wg", "wd")


def hidden(conf: Dict, w: Dict[str, torch.Tensor], tokens: torch.Tensor,
           precision: str = "fp32", remat: bool = False) -> torch.Tensor:
    """The last layer's output (B, S, D), float32; tokens (B, S). Each
    layer's weights are taken to float32 when it runs."""
    d = dims(conf)
    x = w["embed"][tokens.long()].float()
    for l in range(d["L"]):
        args = [w["blocks." + n][l].float() for n in LAYER_LEAVES]
        if remat:
            x = checkpointed(_layer, x, *args, d, precision)
        else:
            x = _layer(x, *args, d, precision)
    return x


def head(conf: Dict, w, x: torch.Tensor, precision: str = "fp32"):
    """Final norm and LM head: (..., D) -> (..., padded vocab) float32."""
    d = dims(conf)
    return mm(rms_norm(x, w["final_norm"], d["eps"]), w["lm_head"],
              precision)


def logits(conf: Dict, w, tokens: torch.Tensor, start: int,
           precision: str = "fp32") -> torch.Tensor:
    """Logits at positions ``start..S-1`` of one sequence (S,)."""
    with torch.no_grad():
        x = hidden(conf, w, tokens[None], precision)[0, start:]
        return head(conf, w, x, precision)


def loss(conf: Dict, w, tokens: torch.Tensor,
         precision: str = "fp32") -> torch.Tensor:
    """The training loss of a batch (B, S): next-token cross-entropy and
    z-loss over the real vocabulary, every layer recomputed in the
    backward."""
    x = hidden(conf, w, tokens, precision, remat=True)
    return logits_loss(head(conf, w, x[:, :-1], precision), tokens[:, 1:],
                       dims(conf)["V"])


def port_fields(conf: Dict) -> Dict:
    """The program's configuration fields this configuration fixes."""
    d = dims(conf)
    return {"num_layers": d["L"], "d_model": d["D"], "num_heads": d["H"],
            "num_kv_heads": d["KV"], "hd": d["hd"], "d_ff": d["F"],
            "vocab_size": d["V"], "padded_vocab": d["Vp"],
            "rope_theta": d["theta"], "rms_eps": d["eps"],
            "qkv_bias": False, "qk_norm": False, "mlp_gated": True,
            "tie_embeddings": False, "pos_emb": "rope", "moe": False,
            "ssm": False, "compute_dtype": conf["torch_dtype"]}


def model_flops_per_token(conf: Dict) -> Dict:
    """Matrix weights a token passes (``body``: the layers; ``head``: the
    LM head) and the attention FLOPs per key attended, all layers."""
    d = dims(conf)
    D, H, KV, hd = d["D"], d["H"], d["KV"], d["hd"]
    layer = 2 * D * H * hd + 2 * D * KV * hd + 3 * D * d["F"]
    return {"body": d["L"] * layer, "head": D * d["Vp"],
            "attn_per_key": 4 * d["L"] * H * hd, "layers": d["L"],
            "attn_layers": d["L"], "d_model": D}

"""Plain reference of a Mamba1 (selective state space) decoder, as the
port runs falcon-mamba-7b: pre-norm RMSNorm layers of an input projection
to ``[x | z]``, a depthwise causal convolution of ``conv_kernel`` taps with
bias and SiLU, the selective scan

    dt = softplus(x_proj_dt(x) @ dt_proj + dt_bias),  A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,  y_t = h_t C_t + D x_t

gated by SiLU(z), and an output projection; an untied LM head. The scan is
the plain sequential recurrence, one step at a time over float32 state.
The departures from the published model (its B, C and dt RMS norms) are
listed under ``assumed`` in the configuration's file. Widths come from the
configuration's file, never from the program.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.common import (checkpointed, logits_loss, mm,
                                        rms_norm, round_up, softplus)
from perfbench.weights import fan_in


def dims(conf: Dict) -> Dict:
    D = conf["hidden_size"]
    return {"L": conf["num_hidden_layers"], "D": D,
            "dI": conf["intermediate_size"], "N": conf["state_size"],
            "K": conf["conv_kernel"], "R": conf["time_step_rank"],
            "V": conf["vocab_size"], "Vp": round_up(conf["vocab_size"], 256),
            "eps": float(conf["layer_norm_epsilon"])}


def shapes(conf: Dict) -> Dict[str, tuple]:
    """name -> (shape, init, matrix): the leaves in the port's layout."""
    d = dims(conf)
    L, D, dI, N, K, R, Vp = (d["L"], d["D"], d["dI"], d["N"], d["K"],
                             d["R"], d["Vp"])
    out = {"embed": ((Vp, D), ("normal", 0.02), True),
           "lm_head": ((D, Vp), ("normal", 0.02), True),
           "final_norm": ((D,), ("const", 1.0), False),
           "blocks.ln1": ((L, D), ("const", 1.0), False),
           "blocks.conv_w": ((L, dI, K), ("normal", 0.2), True),
           "blocks.conv_b": ((L, dI), ("const", 0.0), True),
           "blocks.dt_proj": ((L, R, dI), ("normal", R ** -0.5), True),
           "blocks.dt_bias": ((L, dI), ("uniform_softplus_inv", 1e-3, 1e-1),
                              False),
           "blocks.A_log": ((L, dI, N), ("log_arange", N), False),
           "blocks.ssm_D": ((L, dI), ("const", 1.0), False)}
    for name, shape in (("in_proj", (L, D, 2 * dI)),
                        ("x_proj", (L, dI, R + 2 * N)),
                        ("out_proj", (L, dI, D))):
        out["blocks." + name] = (shape, ("normal", fan_in(shape)), True)
    return out


def kv_bytes_per_token(conf: Dict):
    """None: the state does not grow with the context."""
    return None


class _Recurrence(torch.autograd.Function):
    """h_t = a_t h_{t-1} + u_t from h_0 = 0, one step at a time, and its
    derivative by the reverse recurrence: a (B, S, dI, N) decay, u the
    input; returns every h_t."""

    @staticmethod
    def forward(ctx, a, u):
        hs = torch.empty_like(u)
        h = torch.zeros_like(u[:, 0])
        for t in range(u.shape[1]):
            h = torch.addcmul(u[:, t], a[:, t], h)
            hs[:, t] = h
        ctx.save_for_backward(a, hs)
        return hs

    @staticmethod
    def backward(ctx, g_hs):
        a, hs = ctx.saved_tensors
        g_a, g_u = torch.empty_like(a), torch.empty_like(a)
        g = torch.zeros_like(hs[:, 0])
        for t in range(hs.shape[1] - 1, -1, -1):
            g = g + g_hs[:, t]                 # dL/dh_t
            g_u[:, t] = g
            if t:
                torch.mul(g, hs[:, t - 1], out=g_a[:, t])
            else:
                g_a[:, 0].zero_()
            g = g * a[:, t]                    # on to h_{t-1}
        return g_a, g_u


def scan(dt, A, Bc, Cc, x):
    """The sequential selective scan, float32: dt, x (B, S, dI); A (dI, N);
    Bc, Cc (B, S, N). Returns y (B, S, dI)."""
    dA = torch.exp(dt[..., None] * A)                       # (B, S, dI, N)
    dBx = (dt * x)[..., None] * Bc[:, :, None, :]
    return torch.einsum("bsdn,bsn->bsd", _Recurrence.apply(dA, dBx), Cc)


def _layer(x, ln1, in_proj, conv_w, conv_b, x_proj, dt_proj, dt_bias, A_log,
           ssm_D, out_proj, d, precision):
    S = x.shape[1]
    h = rms_norm(x, ln1, d["eps"])
    x_in, z = mm(h, in_proj, precision).split(d["dI"], dim=-1)
    xp = F.pad(x_in, (0, 0, d["K"] - 1, 0))
    xc = sum(xp[:, k:k + S] * conv_w[:, k] for k in range(d["K"])) + conv_b
    xh = F.silu(xc)
    dtr, Bc, Cc = mm(xh, x_proj, precision).split(
        [d["R"], d["N"], d["N"]], dim=-1)
    dt = softplus(mm(dtr, dt_proj, precision) + dt_bias)
    y = scan(dt, -torch.exp(A_log), Bc, Cc, xh) + ssm_D * xh
    return x + mm(y * F.silu(z), out_proj, precision)


LAYER_LEAVES = ("ln1", "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                "dt_bias", "A_log", "ssm_D", "out_proj")


def hidden(conf: Dict, w, tokens: torch.Tensor, precision: str = "fp32",
           remat: bool = False) -> torch.Tensor:
    """The last layer's output (B, S, D), float32; tokens (B, S)."""
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
    x = hidden(conf, w, tokens, precision, remat=True)
    return logits_loss(head(conf, w, x[:, :-1], precision), tokens[:, 1:],
                       dims(conf)["V"])


def port_fields(conf: Dict) -> Dict:
    """The program's configuration fields this configuration fixes."""
    d = dims(conf)
    return {"num_layers": d["L"], "d_model": d["D"], "d_inner": d["dI"],
            "ssm_state": d["N"], "ssm_conv": d["K"], "dt_rank_": d["R"],
            "vocab_size": d["V"], "padded_vocab": d["Vp"],
            "rms_eps": d["eps"], "ssm": True, "ssm_version": 1,
            "num_heads": 0, "hybrid_attn_every": 0, "tie_embeddings": False,
            "compute_dtype": conf["torch_dtype"]}


def model_flops_per_token(conf: Dict) -> Dict:
    """Matrix weights a token passes and the attention FLOPs per key (none:
    the state does not grow)."""
    d = dims(conf)
    D, dI, N, R = d["D"], d["dI"], d["N"], d["R"]
    layer = D * 2 * dI + dI * (R + 2 * N) + R * dI + dI * D
    return {"body": d["L"] * layer, "head": D * d["Vp"], "attn_per_key": 0,
            "layers": d["L"], "attn_layers": 0, "d_model": D}

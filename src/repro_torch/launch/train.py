"""Training launcher of the port (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --preset full \
        --batch 8 --seq 2048 --microbatches 8 --steps 6

Presets: ``smoke`` (the arch's smoke config, batch 4 x seq 64), ``100m``
(a ~100M-parameter member of the same family, batch 8 x seq 512) and
``full`` (the published config, batch 256 x seq 4096; ``--batch`` and
``--seq`` cut it to one card). The trainer is the conditional taskflow of
:mod:`repro_torch.train.trainer` on the port's work-stealing executor.
Runs on CUDA; without a CUDA device it raises unless ``--device cpu`` is
given. Weights are random, drawn from a ``torch.Generator`` seeded 0.
Prints one JSON line last: ``{"final_loss", "first_loss",
"tokens_per_s"}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from ..configs import get_config
from ..optim.adamw import OptConfig
from ..train.trainer import Trainer, TrainerConfig


def build_cfg(arch: str, preset: str):
    """(config, batch, seq) of a preset, as the reference's."""
    cfg = get_config(arch)
    if preset == "smoke":
        return cfg.smoke(), 4, 64
    if preset == "100m":
        cfg = dataclasses.replace(
            cfg.smoke(), name=cfg.name + "-100m",
            num_layers=12, d_model=768,
            num_heads=0 if cfg.attention_free else 12,
            num_kv_heads=0 if cfg.attention_free else 4,
            head_dim=0 if cfg.attention_free else 64,
            d_ff=2048 if cfg.d_ff else 0,
            vocab_size=32000,
            attn_chunk_q=128, ssm_chunk=64, max_seq_len=2048)
        return cfg, 8, 512
    return cfg, 256, 4096  # full


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help="an attention arch, dense or MoE (e.g. "
                         "stablelm-1.6b, qwen3-14b, qwen2-moe-a2.7b)")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    cfg, batch, seq = build_cfg(args.arch, args.preset)
    batch = args.batch or batch
    seq = args.seq or seq
    opt = OptConfig(lr=args.lr, warmup_steps=max(10, args.steps // 20),
                    total_steps=args.steps)
    tc = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                       log_every=args.log_every,
                       microbatches=args.microbatches)
    t0 = time.time()
    tr = Trainer(cfg, tc, batch=batch, seq_len=seq, opt=opt,
                 ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"batch={batch} seq={seq} steps={args.steps} on {tr.device}",
          flush=True)
    out = tr.run()
    dt = time.time() - t0
    hist = out["history"]
    toks = batch * seq * args.steps
    print(f"done in {dt:.1f}s ({toks/dt:.0f} tok/s); restarts="
          f"{out['restarts']}")
    for h in hist:
        print(f"  step {h['step']:5d} loss {h['loss']:.4f} "
              f"lr {h['lr']:.2e} gnorm {h['grad_norm']:.2f}")
    print(json.dumps({"final_loss": hist[-1]["loss"],
                      "first_loss": hist[0]["loss"],
                      "tokens_per_s": toks / dt}))


if __name__ == "__main__":
    main()

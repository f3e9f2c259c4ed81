"""End-to-end training driver on the port: train an LM for a few steps with
the trainer-as-taskflow (prefetch / device step / async checkpoint /
conditional loop), then greedy-decode from the trained weights through the
serve engine.

The port of ``examples/train_lm.py``, on :mod:`repro_torch.launch.train`'s
presets, :class:`repro_torch.train.trainer.Trainer` and
:class:`repro_torch.serve.engine.ServeEngine`. The default is the arch's
smoke config; ``--preset 100m`` grows it.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 60
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --steps 8

Without ``--device`` it runs on CUDA and raises without it.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.launch.train import build_cfg
from repro_torch.optim.adamw import OptConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    """Train, print the loss history and a sampled continuation; returns
    ``{"history": [...], "sample": tokens}``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, batch, seq = build_cfg(args.arch, args.preset)
    batch = args.batch or batch
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params), "
          f"batch={batch}, seq={seq}, steps={args.steps}, device={dev}")

    with tempfile.TemporaryDirectory() as ckpt:
        tc = TrainerConfig(total_steps=args.steps,
                           ckpt_every=max(20, args.steps // 4),
                           log_every=max(1, args.steps // 12))
        opt = OptConfig(lr=3e-3 if args.preset == "smoke" else 6e-4,
                        warmup_steps=max(5, args.steps // 10),
                        total_steps=args.steps, weight_decay=0.0)
        tr = Trainer(cfg, tc, batch=batch, seq_len=seq, opt=opt,
                     ckpt_dir=ckpt, device=dev)
        out = tr.run()
        hist = out["history"]
        for h in hist:
            print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
                  f"lr {h['lr']:.2e}")
        print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} "
              f"(uniform floor ~{np.log(cfg.vocab_size):.2f})")

        with ServeEngine(cfg, out["state"]["params"], decode_chunk=8,
                         device=dev) as eng:
            prompt = np.arange(1, 17, dtype=np.int32)
            gen = eng.generate([prompt], max_new=16)[0]
        print("sample continuation:", gen.tolist())
    return {"history": hist, "sample": gen}


if __name__ == "__main__":
    main()

"""A throwaway benchmark tree at smoke size for the CPU tests: a copy of
``perfbench/`` with configurations of the program's smoke models, a tiny
chat mix and training mix, their cells, and a ``BENCHMARK.json`` naming
them, all added as files only."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

DENSE = {"name": "dense-tiny", "source": "smoke size of stablelm-1.6b",
         "family": "dense", "port_arch": "stablelm-1.6b-smoke",
         "hidden_size": 64, "intermediate_size": 96,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 503,
         "rope_theta": 10000, "layer_norm_eps": 1e-05,
         "torch_dtype": "bfloat16", "reduced": []}
MAMBA = {"name": "mamba-tiny", "source": "smoke size of falcon-mamba-7b",
         "family": "mamba1", "port_arch": "falcon-mamba-7b-smoke",
         "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
         "state_size": 16, "conv_kernel": 4, "time_step_rank": 8,
         "vocab_size": 503, "layer_norm_epsilon": 1e-05,
         "torch_dtype": "bfloat16", "reduced": []}
CHAT = {"kind": "open_loop", "prompt_len": {"median": 20, "sigma": 0.5,
                                            "min": 8, "max": 40},
        "output_len": {"median": 6, "sigma": 0.5, "min": 3, "max": 10},
        "block": 4, "after_s": 1.0, "trace_s": 1,
        "check_tokens": 16, "check_max_requests": 3}
TRAIN = {"kind": "lm_batches", "batch": 4, "seq_len": 16, "microbatches": 2,
         "warm_steps": 3, "trace_steps": 1,
         "opt": {"lr": 0.01, "warmup_steps": 2, "total_steps": 100,
                 "min_lr_ratio": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
                 "weight_decay": 0.1, "clip_norm": 1.0}}
SERVE_CELL = {"engine": {"max_batch": 4, "max_context": 64,
                         "kv_pool_bytes": 64 * 16 * 256},
              "rate_per_s": 6.0, "ramp_s": 0.5, "grace_s": 60,
              "limits": {"logit_gap": 0.012}}
TRAIN_CELL = {"ref_steps": 3,
              "limits": {"loss_gap": 0.001, "grad_gap": 0.006,
                         "change_gap": 0.008}}


def build(tmp: Path, extra_per_layer=()) -> Path:
    """The tree under ``tmp``; returns its root."""
    shutil.copytree(BENCH, tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp / "perfbench"
    for name, body in (("configs/dense-tiny.json", DENSE),
                       ("configs/mamba-tiny.json", MAMBA),
                       ("traffic/chat-tiny.json", CHAT),
                       ("traffic/train-tiny.json", TRAIN),
                       ("cells/dense-serve.json", SERVE_CELL),
                       ("cells/mamba-serve.json", SERVE_CELL),
                       ("cells/dense-train.json", TRAIN_CELL),
                       ("cells/mamba-train.json", TRAIN_CELL)):
        (b / name).write_text(json.dumps(body))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"] = [
        {"name": c["name"], "source": c["source"],
         "file": f"perfbench/configs/{c['name']}.json", "reduced": [],
         "why": "tiny"} for c in (DENSE, MAMBA)]
    cells = [("dense-serve", "dense-tiny", "chat-tiny"),
             ("mamba-serve", "mamba-tiny", "chat-tiny"),
             ("dense-train", "dense-tiny", "train-tiny"),
             ("mamba-train", "mamba-tiny", "train-tiny")]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t,
                           "chips": 1, "why": "tiny"} for n, c, t in cells]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["per_layer"] += list(extra_per_layer)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp

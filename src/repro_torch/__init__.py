"""repro_torch — the PyTorch/CUDA port of the Taskflow reproduction.

A second package beside the JAX one (``repro``), with the same module
layout so each counterpart is easy to find. It imports ``torch`` and never
``jax``; the host runtime (task graphs, work-stealing executor, pipelines,
scheduler) is carried over as JAX-free copies. The serving hot path runs
through hand-written CUDA kernels for Hopper (``kernels/csrc``) on a CUDA
tensor and through their plain PyTorch versions on a CPU tensor.

Serving: ``repro_torch.serve.engine.ServeEngine`` and
``python -m repro_torch.launch.serve``. Training (attention archs, dense
and MoE): ``repro_torch.train.Trainer`` and
``python -m repro_torch.launch.train``.
"""
__all__ = ["configs", "core", "data", "kernels", "models", "optim",
           "params", "pipeline", "serve", "train", "tree"]

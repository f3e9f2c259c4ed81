"""Continuous-batching serve subsystem of the port (slice 1).

* :mod:`.engine`    — the resident admit→prefill→decode→complete pipeline
  (synchronous, single-device, paged-KV subset of the reference engine);
* :mod:`.scheduler` — copy of the reference's tiered admission queue;
* :mod:`.errors`    — copy of the typed failure vocabulary;
* :mod:`.kvcache`   — the host ``BlockPool`` plus in-place torch scatters
  and gathers through per-sequence block tables.

Imports stay lazy here so that ``import repro_torch.serve.kvcache`` does
not pull in the engine.
"""

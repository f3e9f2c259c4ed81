"""Continuous-batching serve subsystem of the port (slice 1).

* :mod:`.engine`    — the resident admit→prefill→decode→complete pipeline
  (synchronous, single-device, paged-KV subset of the reference engine);
* :mod:`.scheduler` — copy of the reference's tiered admission queue;
* :mod:`.errors`    — copy of the typed failure vocabulary;
* :mod:`.kvcache`   — the host ``BlockPool`` plus in-place torch scatters
  and gathers through per-sequence block tables, and ``copy_blocks``;
* :mod:`.prefix`    — copy of the reference's ``PrefixCache``, the hash trie
  over block-aligned prompt chunks behind the engine's ``prefix_cache``.

``ServeEngine``, ``ServeRequest`` and ``PrefixCache`` are exported here,
resolved lazily, so that ``import repro_torch.serve.kvcache`` does not pull
in the engine.
"""

__all__ = ["ServeEngine", "ServeRequest", "PrefixCache"]


def __getattr__(name):
    if name == "PrefixCache":
        from .prefix import PrefixCache
        return PrefixCache
    if name in ("ServeEngine", "ServeRequest"):
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

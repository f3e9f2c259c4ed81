"""Continuous-batching serve subsystem of the port (slice 1).

* :mod:`.engine`    — the resident admit→prefill→decode→complete pipeline
  (single-device subset of the reference engine, with its async decode
  lookahead, SLO overload control and per-row failure isolation);
* :mod:`.faultinject` — copy of the reference's seeded fault injector;
* :mod:`.scheduler` — copy of the reference's tiered admission queue;
* :mod:`.errors`    — copy of the typed failure vocabulary;
* :mod:`.kvcache`   — the host ``BlockPool`` plus in-place torch scatters
  and gathers through per-sequence block tables, ``copy_blocks`` and
  ``set_carry_rows``;
* :mod:`.prefix`    — copy of the reference's ``PrefixCache``, the hash trie
  over block-aligned prompt chunks behind the engine's ``prefix_cache``.
* :mod:`.chunk_graph` — the decode chunk as one program over static
  buffers (one CUDA graph replay a chunk on the card) and the async
  engine's host-device copies that never wait for the stream.

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

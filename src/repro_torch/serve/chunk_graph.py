"""The serve engine's decode chunk as one program over static buffers, and
the host-device copies of the async engine that do not wait for it.

:class:`ChunkProgram` is the port's counterpart of the reference engine's
compiled chunk (``self._decode_paged = jax.jit(...)``, ``self._decode_n``):
``n`` greedy decode steps of the whole resident batch, as ONE program. On
CUDA it is captured once as a ``torch.cuda.CUDAGraph`` and every chunk is
one ``replay()``: one host call instead of ``n`` steps x layers of kernel
launches from Python, which the host can queue behind the chunk in flight,
as JAX's async dispatch queues a jitted program. On the CPU (and on CUDA
when the engine asks for it, ``graph=False``) the same body runs eagerly.

The program reads and writes fixed tensors only:

* ``carry`` (3, B) int32 — rows ``lengths``, ``last``, ``rem``. A chunk
  reads it and writes the advanced carry back into it, so chunk N+1
  consumes chunk N's carry on the device (the reference's ``self._carry =
  (ln, tok, rm)``); the engine writes rows of it in place between chunks
  (:func:`repro_torch.serve.kvcache.set_carry_rows`) or, synchronously,
  copies its host mirrors into it;
* ``out`` (B, n + 3) int32 — the chunk's tokens in ``[:, :n]`` and the
  advanced carry, transposed, in ``[:, n:]``, so the synchronous engine
  reads both back in one copy. Callers only ever copy out of it: the next
  replay overwrites it;
* the engine's pool (paged KV, or the slot-state pool), its device block
  tables and the weights, all written in place by the engine.

A graph bakes in those tensors' addresses. The engine never rebinds them;
:meth:`ChunkProgram.run` checks every replay against the addresses it
captured and raises if one moved. Capture happens in the engine's
constructor on the caller's thread: one eager warm-up on a side stream
(library handles, the allocator), then the capture with
``capture_error_mode="thread_local"``, so no other thread's CUDA call can
break it. A failed capture raises; nothing falls back to the eager chunk.

Kernel launch counts: the kernels' wrappers count when called, i.e. once
at capture. The capture's counts are taken back and kept in
:attr:`ChunkProgram.captured_launches`, and every replay adds them again
(:func:`repro_torch.kernels.ops.add_launches`): each replay launches
them.

:class:`HostLink` is the async engine's host side of the stream. A
blocking ``.to(cuda)`` from pageable memory or ``.cpu()`` synchronises the
stream, so anything the engine uploads or reads after dispatching chunk
N+1 would wait for N+1 to finish. HostLink uploads through pinned staging
with ``non_blocking=True`` (the caching host allocator keeps each staging
block until an event recorded at its copy has passed) and reads into
pinned memory behind an event that the engine waits on where the
reference blocks.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..device import collection_paused

__all__ = ["ChunkProgram", "HostLink"]


class ChunkProgram:
    """``n`` decode steps over static buffers (see the module docstring).

    step:
        ``step((lengths, last, rem)) -> (state, (lengths, last, rem),
        toks)``: :func:`repro_torch.models.lm.decode_chunk_paged` or
        ``decode_chunk_slots`` bound to the engine's pool and weights.
    statics:
        ``statics() -> [(name, tensor)]``, every other tensor the program
        reads or writes (pool, tables, slot state, weights), read from the
        engine's attributes at each call.
    graph:
        capture a CUDA graph (CUDA only) or run the body eagerly.
    """

    def __init__(self, step: Callable, statics: Callable[[], Iterable],
                 batch: int, n: int, device: torch.device,
                 graph: bool) -> None:
        if graph and device.type != "cuda":
            raise ValueError("a CUDA graph of the decode chunk needs a CUDA "
                             f"device, got {device}")
        self.n = n
        self.carry = torch.zeros((3, batch), dtype=torch.int32,
                                 device=device)
        self.out = torch.zeros((batch, n + 3), dtype=torch.int32,
                               device=device)
        self._step = step
        self._statics = statics
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: replays so far (graph mode)
        self.replays = 0
        #: kernel launches recorded in the graph, by kernel
        self.captured_launches: Dict[str, int] = {}
        self._ptrs: Optional[List[Tuple[str, int]]] = None
        if graph:
            self._capture(device)

    def _body(self) -> None:
        n, c = self.n, self.carry
        _, (ln, tok, rm), toks = self._step((c[0], c[1], c[2]))
        adv = torch.stack([ln, tok, rm])
        self.out[:, :n].copy_(toks)
        self.out[:, n:].copy_(adv.t())
        c.copy_(adv)

    def _pointers(self) -> List[Tuple[str, int]]:
        return [("carry", self.carry.data_ptr()),
                ("out", self.out.data_ptr())] + \
            [(name, t.data_ptr()) for name, t in self._statics()]

    def _capture(self, device: torch.device) -> None:
        from ..kernels import ops
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        # the warm-up writes what a chunk writes: the engine captures before
        # any row is seated (carry all zero, every row inactive), so paged
        # KV writes go to the sink and slot rows are overwritten at seating
        with torch.cuda.stream(side):
            self._body()
        side.synchronize()
        before = ops.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with collection_paused(), torch.cuda.graph(
                self.graph, stream=side, capture_error_mode="thread_local"):
            self._body()
        after = ops.launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}
        ops.add_launches({k: -v for k, v in self.captured_launches.items()})
        cur.wait_stream(side)
        self._ptrs = self._pointers()

    def release(self) -> None:
        """Free the captured graph now and drop the references back to the
        engine (its step and statics), so the graph never waits in a
        reference cycle for the garbage collector, which could destroy it
        inside another capture. The program cannot run afterwards; the
        reset graph object stays, so :attr:`graph` still tells whether the
        chunk was captured."""
        if self.graph is not None:
            self.graph.reset()
        self._step = self._statics = None

    def run(self) -> None:
        """One chunk on the current stream: a replay in graph mode (after
        the address check), else the eager body."""
        if self.graph is None:
            self._body()
            return
        now = self._pointers()
        if now != self._ptrs:
            moved = [a[0] for a, b in zip(self._ptrs, now) if a != b] \
                or ["(tensor set changed)"]
            raise RuntimeError(f"decode chunk graph: {moved} rebound after "
                               "capture; the engine must write them in place")
        self.graph.replay()
        self.replays += 1
        from ..kernels import ops
        ops.add_launches(self.captured_launches)


class HostLink:
    """Host-device copies that never synchronise the stream (CUDA), or
    plain copies (CPU, where every op has finished when it returns).
    Thread-safe: the prefill and decode stages share one link.

    An upload stages each array in pinned memory from PyTorch's caching
    host allocator and copies it with ``non_blocking=True``: the allocator
    records an event on the staging block at that copy and hands the
    block out again only once the event has passed, which is what keeps
    the staging alive until the stream has read it. Reads into a caller's
    buffer re-record one event per buffer. Every torch call costs the
    decode stage host time under the pipeline's GIL traffic, so both do
    as few as they can."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._cuda = device.type == "cuda"
        self._read_ev: Dict[int, torch.cuda.Event] = {}

    def upload(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """Device copies of ``arrays``, enqueued on the current stream."""
        out = []
        for a in arrays:
            h = torch.from_numpy(np.ascontiguousarray(a))
            if self._cuda:
                h = h.pin_memory().to(self.device, non_blocking=True)
            out.append(h)
        return out

    def read(self, t: torch.Tensor, into: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Enqueue a copy of ``t`` to the host (``into``, pinned, or a new
        pinned tensor) and return it with the event to wait on (None on
        the CPU, where the copy is done). ``into``'s event is reused: wait
        on one read of it before reading into it again."""
        if not self._cuda:
            if into is None:
                return t.clone(), None
            into.copy_(t)
            return into, None
        if into is None:
            into = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            ev = torch.cuda.Event()
        else:
            ev = self._read_ev.get(into.data_ptr())
            if ev is None:
                ev = self._read_ev[into.data_ptr()] = torch.cuda.Event()
        into.copy_(t, non_blocking=True)
        ev.record()
        return into, ev

    @staticmethod
    def wait(host: torch.Tensor, ev: Optional[torch.cuda.Event]
             ) -> np.ndarray:
        """The numpy view of a :meth:`read`'s result, once it has landed."""
        if ev is not None:
            ev.synchronize()
        return host.numpy()

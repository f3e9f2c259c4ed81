"""The device program of a conditional task graph (``csrc/cond_graph.cu``).

The mechanism behind :meth:`repro_torch.core.condgraph.CondGraph.compile`
for a graph with condition tasks: the blocks' captured CUDA graphs under one
WHILE node and one IF node per block, launched with one
``cudaGraphLaunch``. It is the counterpart of the ``lax.while_loop`` /
``lax.switch`` program of ``repro.core.jaxgraph`` and replaces no TPU
kernel. :meth:`CondProgram.nest` builds the same program into a graph that
a stream is capturing (a DeviceFlow that holds a compiled ``CondGraph``),
so the capturing graph's replay runs the whole loop. Its plain version is
``CondGraph.lower()``, the same machine driven from the host. There is no CPU form: :class:`CondProgram` takes CUDA
buffers and raises without them, and ``CondGraph.compile`` gives a CPU
state ``lower()``'s function instead.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import _build

__all__ = ["CondProgram", "check_block", "count_nodes", "versions",
           "launches"]

#: launches of compiled conditional programs in this process (one
#: ``cudaGraphLaunch`` each, whatever the trip count)
launches = 0

#: the first CUDA version with conditional WHILE and IF nodes
MIN_CUDA = 12040
#: the most blocks a program holds (``kMaxBlocks`` in the source: the IF
#: nodes' handles reach the dispatch kernel by value)
MAX_BLOCKS = 256
#: trip bound when the caller gives none (the C entry point takes an int)
_NO_BOUND = 2**31 - 1
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "child graph", 5: "empty", 6: "event wait",
               7: "event record", 8: "external semaphore signal",
               9: "external semaphore wait", 10: "memory allocation",
               11: "memory free", 13: "conditional"}


def versions(device: Optional[int] = None) -> dict:
    """The CUDA versions the library was built with and runs on."""
    lib = _build.ensure_built(device)
    out = (ctypes.c_int * 3)()
    _build.check(lib.repro_cond_graph_versions(out), "cond_graph versions")
    return {"toolkit": out[0], "runtime": out[1], "driver": out[2]}


def _require_conditional_nodes(device: int) -> None:
    v = versions(device)
    low = {k: n for k, n in v.items() if n < MIN_CUDA}
    if low:
        raise RuntimeError(
            f"conditional CUDA graph nodes need CUDA >= 12.4; this build has "
            f"{v} (below: {sorted(low)}); there is no host fallback")


def check_block(raw_graph: int, tasks: Sequence[str],
                device: Optional[int] = None) -> None:
    """Raise, naming ``tasks``, if the captured graph holds a node that a
    conditional body cannot (event, host, allocation nodes...)."""
    lib = _build.ensure_built(device)
    bad = ctypes.c_int(-1)
    _build.check(lib.repro_cond_graph_check(raw_graph, ctypes.byref(bad)),
                 "cond_graph check")
    if bad.value >= 0:
        kind = _NODE_TYPES.get(bad.value, f"type {bad.value}")
        raise RuntimeError(
            f"CondGraph.compile: the block of tasks {list(tasks)} captured a "
            f"{kind} node, which a conditional graph body cannot hold")


def count_nodes(raw_graph: int, device: Optional[int] = None) -> int:
    """Nodes of a CUDA graph, counted through its child graphs."""
    lib = _build.ensure_built(device)
    n = ctypes.c_longlong(0)
    _build.check(lib.repro_cond_graph_count(raw_graph, ctypes.byref(n)),
                 "cond_graph count")
    return n.value


class CondProgram:
    """One instantiated WHILE/IF program over captured block graphs.

    ``blocks``: the blocks' ``cudaGraph_t`` (``CUDAGraph.raw_cuda_graph()``
    of graphs captured with ``keep_graph=True``; each is cloned into the
    program, and the caller keeps them alive for :meth:`nest`);
    ``succ[b]``: block b's successor pcs (``len(blocks)`` is
    STOP); ``is_cond[b]``: whether block b ends in a condition task, whose
    index the block writes into ``ctrl[2]``; ``start``: the first block;
    ``max_iters``: the bound on blocks run (None: none); ``ctrl``: the
    int64[4] device buffer the blocks were captured against."""

    def __init__(self, blocks: Sequence[int], names: Sequence[Sequence[str]],
                 succ: Sequence[Sequence[int]], is_cond: Sequence[bool],
                 start: int, max_iters: Optional[int],
                 ctrl: torch.Tensor) -> None:
        n = len(blocks)
        if not (ctrl.is_cuda and ctrl.dtype == torch.int64
                and ctrl.numel() >= 4 and ctrl.is_contiguous()):
            raise ValueError("CondProgram: ctrl must be a contiguous int64 "
                             "CUDA tensor of 4 entries")
        if not (len(names) == len(succ) == len(is_cond) == n and n > 0):
            raise ValueError("CondProgram: one name list, successor row and "
                             "is_cond flag per block")
        if n > MAX_BLOCKS:
            raise ValueError(f"CondProgram: {n} blocks, at most "
                             f"{MAX_BLOCKS}")
        if max_iters is not None and not 0 <= max_iters <= _NO_BOUND:
            raise ValueError(f"CondProgram: max_iters={max_iters}")
        dev = ctrl.device
        self.device = dev
        self._lib = _build.ensure_built(dev.index)
        _require_conditional_nodes(dev.index)
        for raw, tasks in zip(blocks, names):
            check_block(raw, tasks, dev.index)
        width = max(len(r) for r in succ)
        table: List[int] = []
        for row in succ:
            table += list(row) + [n] * (width - len(row))
        # the buffers the control kernels read; kept alive with the program
        self._succ = torch.tensor(table, dtype=torch.int32, device=dev)
        self._meta = torch.tensor(
            [v for row, c in zip(succ, is_cond) for v in (len(row), int(c))],
            dtype=torch.int32, device=dev)
        self._ctrl = ctrl
        torch.cuda.synchronize(dev)
        arr = (ctypes.c_void_p * n)(*blocks)
        handle = ctypes.c_void_p()
        _build.check(self._lib.repro_cond_graph_create(
            arr, n, start, _NO_BOUND if max_iters is None else max_iters,
            ctrl.data_ptr(), self._succ.data_ptr(), self._meta.data_ptr(),
            width, dev.index, ctypes.byref(handle)),
            "cond_graph create")
        self._handle = handle

    def launch(self) -> None:
        """One ``cudaGraphLaunch`` of the program on PyTorch's current
        stream; no host sync."""
        global launches
        err = self._lib.repro_cond_graph_launch(
            self._handle, _build.current_stream(self.device.index))
        _build.check(err, "cond_graph launch")
        launches += 1

    def nest(self) -> None:
        """Build the program into the CUDA graph that PyTorch's current
        stream is capturing, after the capture's dependencies; the
        capture continues after it. Raises when the stream is not
        capturing. Counted in :data:`launches` once: every replay of the
        capturing graph runs the loop, with no launch of its own."""
        global launches
        if not torch.cuda.is_current_stream_capturing():
            raise RuntimeError("CondProgram.nest: the current stream is not "
                               "capturing a CUDA graph")
        err = self._lib.repro_cond_graph_nest(
            self._handle, _build.current_stream(self.device.index))
        _build.check(err, "cond_graph nest")
        launches += 1

    def nodes(self) -> int:
        """Nodes of the program through the WHILE body, the IF bodies and
        the blocks' graphs."""
        n = ctypes.c_longlong(0)
        _build.check(self._lib.repro_cond_graph_nodes(self._handle,
                                                      ctypes.byref(n)),
                     "cond_graph nodes")
        return n.value

    def __del__(self) -> None:
        handle = getattr(self, "_handle", None)
        if handle is not None and handle.value:
            self._lib.repro_cond_graph_destroy(handle)
            self._handle = None

"""In-graph conditional task graphs on CUDA — the device form of §3.4.

The counterpart of ``repro.core.jaxgraph.JaxGraph``. The paper's
*conditional tasking* lets a task graph hold branches and cycles so that an
iterative workload needs neither static unrolling (memory that grows with
the trip count, paper Fig. 13/17) nor a host launch per iteration. The JAX
package gets this from control flow inside one XLA program; here it comes
from CUDA-graph conditional nodes:

* a graph whose tasks are functions over a shared state pytree of tensors
  is compiled into ONE CUDA graph, launched with one ``cudaGraphLaunch``;
* a DAG becomes one ``torch.cuda.CUDAGraph`` capture of its topological
  composition;
* a graph with condition tasks (possibly cyclic) becomes a
  **program-counter machine**: a WHILE node whose body runs the current
  *basic block* through one IF node per block (``kernels/csrc/
  cond_graph.cu``, the counterpart of ``lax.while_loop`` around
  ``lax.switch``). Chains of single-entry single-exit static tasks are
  merged into superblocks, as in the reference.

:meth:`CondGraph.lower` returns the plain version: the DAG composition, or
the PC machine driven from the host, which reads each condition's index
back with ``int()``. On a CPU state :meth:`CondGraph.compile` returns that
function; on a CUDA state it returns the one-launch program, or raises
(naming the task) when a block cannot be captured. Nothing falls back from
the card to the host loop.

Differences from the reference, and why:

* The machine starts at the entry task's block. The reference starts at
  block 0, the first *added* node that begins a block, so a graph whose
  entry was not added first skips its entry task there.
* The compiled program copies its input into static device buffers and
  returns fresh tensors, as ``jax.jit`` returns new arrays; it raises on a
  state whose structure, shapes or dtypes differ from the example's.
* Every block of a PC machine must keep the state's structure, shapes and
  dtypes (``lax.while_loop`` and ``lax.switch`` ask the same of their
  branches); both the compiled program and the plain version raise
  ``TypeError`` naming the task that does not.
* Tasks must be capturable on the card: no host syncs (``.item()``,
  ``int()`` of a tensor), no data-dependent shapes, no random numbers (a
  replay outside ``CUDAGraph.replay`` does not advance the generator).
* A compiled program owns its static buffers: calls from two threads at
  once race on them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..device import collection_paused

__all__ = ["CondGraph", "STOP"]


class _Stop:
    def __repr__(self) -> str:
        return "STOP"


#: Sentinel successor: leaving through it terminates the graph program.
STOP = _Stop()


class CNode:
    __slots__ = ("fn", "kind", "name", "successors")

    def __init__(self, fn: Callable, kind: str, name: str) -> None:
        self.fn = fn
        self.kind = kind  # "task" | "cond"
        self.name = name
        self.successors: List[Any] = []  # CNode or STOP


class CTask:
    __slots__ = ("_node",)

    def __init__(self, node: CNode) -> None:
        self._node = node

    def precede(self, *others: Any) -> "CTask":
        for o in others:
            self._node.successors.append(o if o is STOP else o._node)
        return self

    def succeed(self, *others: "CTask") -> "CTask":
        for o in others:
            o._node.successors.append(self._node)
        return self

    @property
    def name(self) -> str:
        return self._node.name


class CondGraph:
    """Build a (possibly cyclic) graph of state transformers."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._nodes: List[CNode] = []

    # -- construction -----------------------------------------------------------
    def task(self, fn: Callable[[Any], Any], name: str = "") -> CTask:
        """Static task: ``state -> state``."""
        n = CNode(fn, "task", name or f"t{len(self._nodes)}")
        self._nodes.append(n)
        return CTask(n)

    def cond(self, fn: Callable[[Any], Tuple[Any, Any]], name: str = ""
             ) -> CTask:
        """Condition task: ``state -> (successor_index, state)``, the index
        a 0-d integer tensor (or a Python int) selecting among this task's
        successors (paper §3.4)."""
        n = CNode(fn, "cond", name or f"c{len(self._nodes)}")
        self._nodes.append(n)
        return CTask(n)

    # -- analysis (as in the reference) -------------------------------------------
    def _preds(self) -> Dict[CNode, List[CNode]]:
        preds: Dict[CNode, List[CNode]] = {n: [] for n in self._nodes}
        for n in self._nodes:
            for s in n.successors:
                if s is not STOP:
                    preds[s].append(n)
        return preds

    def _is_dag(self) -> bool:
        if any(n.kind == "cond" for n in self._nodes):
            return False
        color: Dict[CNode, int] = {}

        def dfs(n: CNode) -> bool:
            color[n] = 1
            for s in n.successors:
                if s is STOP:
                    continue
                c = color.get(s, 0)
                if c == 1 or (c == 0 and not dfs(s)):
                    return False
            color[n] = 2
            return True

        return all(dfs(n) for n in self._nodes if color.get(n, 0) == 0)

    def _topo_order(self) -> List[CNode]:
        preds = self._preds()
        indeg = {n: len(ps) for n, ps in preds.items()}
        stack = [n for n in self._nodes if indeg[n] == 0]
        order = []
        while stack:
            n = stack.pop()
            order.append(n)
            for s in n.successors:
                if s is STOP:
                    continue
                indeg[s] -= 1
                if indeg[s] == 0:
                    stack.append(s)
        if len(order) != len(self._nodes):
            raise ValueError("graph has a cycle but no condition task")
        return order

    def _entry(self, preds: Dict[CNode, List[CNode]]) -> CNode:
        # entry = unique node with no STRONG predecessor (weak back-edges
        # from condition tasks do not gate the start — paper §3.4.1 applied
        # to the do-while idiom).
        sources = [n for n in self._nodes
                   if not any(p.kind != "cond" for p in preds[n])]
        if len(sources) > 1:  # prefer a true zero-dependency source
            no_pred = [n for n in sources if not preds[n]]
            if len(no_pred) == 1:
                sources = no_pred
        if len(sources) != 1:
            raise ValueError(
                f"cyclic graph must have exactly one entry task, got "
                f"{[n.name for n in sources]}")
        return sources[0]

    def _blocks(self) -> Tuple[List[List[CNode]], Dict[CNode, int]]:
        """Partition into superblocks: maximal chains of single-pred static
        tasks, each optionally terminated by a condition task."""
        preds = self._preds()
        entry = self._entry(preds)
        for n in self._nodes:
            if n.kind == "task" and len(n.successors) > 1:
                raise ValueError(
                    f"static task {n.name!r} has multiple successors in a "
                    "conditional graph; merge the fan-out into one task "
                    "(SPMD control flow cannot fork threads — DESIGN.md §2.3)")
        # jump targets begin blocks
        targets = {entry}
        for n in self._nodes:
            if n.kind == "cond":
                for s in n.successors:
                    if s is not STOP:
                        targets.add(s)
            if len(preds[n]) > 1:
                targets.add(n)
        blocks: List[List[CNode]] = []
        block_of: Dict[CNode, int] = {}
        for t in self._nodes:
            if t not in targets:
                continue
            chain = [t]
            cur = t
            while cur.kind == "task":  # cond terminators end the chain
                succs = cur.successors
                if not succs or succs[0] is STOP or succs[0] in targets:
                    break
                cur = succs[0]
                chain.append(cur)
            blocks.append(chain)
            for n in chain:
                block_of[n] = len(blocks) - 1
        # sanity: every node must live in exactly one block
        placed = sum(len(b) for b in blocks)
        if placed != len(self._nodes):
            unplaced = [n.name for n in self._nodes if n not in block_of]
            raise ValueError(f"unreachable tasks (no path from source): "
                             f"{unplaced}")
        return blocks, block_of

    def _machine(self) -> "_Machine":
        blocks, block_of = self._blocks()
        return _Machine(blocks, block_of,
                        block_of[self._entry(self._preds())])

    # -- lowering ----------------------------------------------------------------
    def lower(self, *, max_iters: Optional[int] = None
              ) -> Callable[[Any], Any]:
        """The plain version, ``state -> state``.

        DAG graphs become their topological composition; conditional or
        cyclic graphs become the PC machine driven from the host: each
        condition's index is read back with ``int()`` (a sync on the card),
        an index outside ``[0, len(successors))`` takes no successor, and
        ``max_iters`` optionally bounds the number of blocks run.
        """
        if not self._nodes:
            return lambda state: state
        if self._is_dag():
            order = self._topo_order()

            def run_dag(state):
                for n in order:
                    state = n.fn(state)
                return state

            return run_dag
        m = self._machine()

        def run(state):
            spec = _signature(state, "CondGraph")
            pc, it = m.start, 0
            while pc < m.stop_pc and (max_iters is None or it < max_iters):
                chain = m.blocks[pc]
                for n in chain[:-1]:
                    state = n.fn(state)
                term = chain[-1]
                if term.kind == "cond":
                    idx, state = term.fn(state)
                    pc = m.next_pc(pc, int(idx))
                else:
                    state = term.fn(state)
                    pc = m.next_pc(pc, 0)
                _check_carry(spec, state, chain)
                it += 1
            return state

        return run

    def compile(self, example_state: Any, **kw) -> Callable[[Any], Any]:
        """ONE launch for the whole graph, the cudaFlow/CUDA-graph effect of
        paper §3.5, built for states shaped like ``example_state``.

        A CUDA state gets a CUDA graph: one capture of the composition for
        a DAG, the WHILE/IF program of ``kernels/csrc/cond_graph.cu`` for a
        conditional graph (``max_iters`` as in :meth:`lower`). A CPU state
        gets :meth:`lower`'s function. Raises, naming the task, when a block
        cannot be captured."""
        leaves, _ = pytree.tree_flatten(example_state)
        devices = {t.device for t in leaves if isinstance(t, torch.Tensor)}
        if len(devices) != 1 or len(leaves) != sum(
                isinstance(t, torch.Tensor) for t in leaves):
            raise TypeError("CondGraph.compile: the state must be a pytree "
                            "of tensors on one device, got "
                            f"{[type(t).__name__ for t in leaves]} on "
                            f"{sorted(map(str, devices))}")
        device = devices.pop()
        plain = self.lower(**kw)
        if device.type != "cuda":
            return plain
        if not self._nodes or self._is_dag():
            return _DagProgram(plain, example_state, device)
        return _PcProgram(self._machine(), example_state, device,
                          kw.get("max_iters"))

    # -- eager reference interpreter (oracle for tests/benchmarks) ----------------
    def run_reference(self, state: Any, max_iters: int = 10_000) -> Any:
        """Execute the graph eagerly in Python — the unrolled / host-driven
        semantics the paper's DAG baselines use. Oracle for ``lower()``."""
        if self._is_dag():
            for n in self._topo_order():
                state = n.fn(state)
            return state
        blocks, block_of = self._blocks()
        pc = block_of[self._entry(self._preds())]
        for _ in range(max_iters):
            chain = blocks[pc]
            for n in chain[:-1]:
                state = n.fn(state)
            term = chain[-1]
            if term.kind == "cond":
                idx, state = term.fn(state)
                idx = int(idx)
                if 0 <= idx < len(term.successors):
                    s = term.successors[idx]
                    pc = len(blocks) if s is STOP else block_of[s]
                else:
                    pc = len(blocks)  # out-of-range: no successor taken
            else:
                state = term.fn(state)
                if term.successors and term.successors[0] is not STOP:
                    pc = block_of[term.successors[0]]
                else:
                    pc = len(blocks)
            if pc >= len(blocks):
                return state
        raise RuntimeError("reference interpreter exceeded max_iters")


class _Machine:
    """The PC machine of a conditional graph: its blocks, the start block,
    and each block's successor table (``STOP`` and a missing successor map
    to ``stop_pc``)."""

    def __init__(self, blocks: List[List[CNode]],
                 block_of: Dict[CNode, int], start: int) -> None:
        self.blocks = blocks
        self.start = start
        self.stop_pc = len(blocks)
        self.succ: List[List[int]] = []
        for chain in blocks:
            term = chain[-1]
            if term.kind == "cond":
                row = [self.stop_pc if s is STOP else block_of[s]
                       for s in term.successors]
            elif term.successors and term.successors[0] is not STOP:
                row = [block_of[term.successors[0]]]
            else:
                row = [self.stop_pc]
            self.succ.append(row)

    def next_pc(self, pc: int, idx: int) -> int:
        row = self.succ[pc]
        return row[idx] if 0 <= idx < len(row) else self.stop_pc

    def is_cond(self, pc: int) -> bool:
        return self.blocks[pc][-1].kind == "cond"


def _signature(state: Any, what: str):
    leaves, spec = pytree.tree_flatten(state)
    for t in leaves:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{what}: state leaf of type "
                            f"{type(t).__name__}; every leaf must be a tensor")
    return spec, [(tuple(t.shape), t.dtype) for t in leaves]


def _check_carry(sig, state: Any, chain: Sequence[CNode]) -> None:
    """A block keeps the state's structure, shapes and dtypes (what
    ``lax.while_loop`` asks of its body)."""
    got = _signature(state, "CondGraph")
    if got != sig:
        names = [n.name for n in chain]
        raise TypeError(
            f"CondGraph: block {names} changed the state from "
            f"{sig[0]} {sig[1]} to {got[0]} {got[1]}; a conditional graph's "
            "tasks must keep its structure, shapes and dtypes")


class _StaticState:
    """Device buffers a compiled program reads, filled from each call's
    input; the check that an input matches the example state."""

    def __init__(self, example: Any, device: torch.device) -> None:
        self.device = device
        self.sig = _signature(example, "CondGraph.compile")
        leaves, self.spec = pytree.tree_flatten(example)
        self.bufs = [torch.empty_like(t, device=device) for t in leaves]
        self.fill(example)

    def fill(self, state: Any) -> None:
        leaves, spec = pytree.tree_flatten(state)
        sig = _signature(state, "CondGraph program")
        if sig != self.sig:
            raise TypeError(f"CondGraph program: state {sig[0]} {sig[1]} "
                            f"differs from the compiled {self.sig[0]} "
                            f"{self.sig[1]}")
        for buf, t in zip(self.bufs, leaves):
            if t.device != self.device:
                raise ValueError(f"CondGraph program: a state leaf is on "
                                 f"{t.device}, the program on {self.device}")
            if t is not buf:
                buf.copy_(t, non_blocking=True)

    def tree(self, leaves: Optional[List[torch.Tensor]] = None) -> Any:
        return pytree.tree_unflatten(self.bufs if leaves is None else leaves,
                                     self.spec)


class _DagProgram:
    """A DAG as one captured CUDA graph of its composition. Called while
    the current stream is capturing (a DeviceFlow op), it runs the
    composition into that capture, as a jitted function inlines into the
    program that calls it."""

    def __init__(self, fn: Callable[[Any], Any], example: Any,
                 device: torch.device) -> None:
        self._fn = fn
        self.static = _StaticState(example, device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):           # warm-up, outside capture
            fn(self.static.tree())
        side.synchronize()
        self.static.fill(example)
        self.graph = torch.cuda.CUDAGraph()
        with collection_paused(), torch.cuda.graph(
                self.graph, stream=side, capture_error_mode="thread_local"):
            out = fn(self.static.tree())
        self.out, self.out_spec = pytree.tree_flatten(out)
        self.num_launches = 0

    def __call__(self, state: Any) -> Any:
        self.static.fill(state)
        self.num_launches += 1
        if torch.cuda.is_current_stream_capturing():
            return self._fn(self.static.tree())
        self.graph.replay()
        return pytree.tree_unflatten(
            [t.clone() if isinstance(t, torch.Tensor) else t
             for t in self.out], self.out_spec)


class _PcProgram:
    """A conditional graph as one CUDA graph: each block captured into its
    own graph (one shared memory pool), all of them under the WHILE/IF
    program that ``kernels/cond_graph.py`` builds. Called while the current
    stream is capturing (a DeviceFlow op), it builds that program into the
    capture (:meth:`CondProgram.nest`) instead of launching it: the
    capture's replays run the loop, and only the capture counts in
    :attr:`num_launches`."""

    def __init__(self, m: _Machine, example: Any, device: torch.device,
                 max_iters: Optional[int]) -> None:
        from ..kernels import cond_graph

        self.machine = m
        self.static = _StaticState(example, device)
        # ctrl = (pc, blocks run, condition index, spare), int64, read and
        # written by the program's control kernels
        self.ctrl = torch.zeros(4, dtype=torch.int64, device=device)
        self._storages = {t.untyped_storage().data_ptr()
                          for t in self.static.bufs}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):           # warm-up, outside capture
            for pc in range(m.stop_pc):
                self._run_block(pc)
        side.synchronize()
        self.static.fill(example)
        #: the memory pool the block graphs share
        self.pool = pool = torch.cuda.graph_pool_handle()
        self.block_graphs: List[torch.cuda.CUDAGraph] = []
        for pc, chain in enumerate(m.blocks):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with collection_paused(), torch.cuda.graph(
                        g, pool=pool, stream=side,
                        capture_error_mode="thread_local"):
                    self._run_block(pc)
            except Exception as e:  # noqa: BLE001 — re-raised with the task
                raise RuntimeError(
                    f"CondGraph.compile: the block of tasks "
                    f"{[n.name for n in chain]} cannot be captured into a "
                    f"CUDA graph: {type(e).__name__}: {e}") from e
            self.block_graphs.append(g)
        self.program = cond_graph.CondProgram(
            [g.raw_cuda_graph() for g in self.block_graphs],
            [[n.name for n in chain] for chain in m.blocks],
            m.succ, [m.is_cond(pc) for pc in range(m.stop_pc)], m.start,
            max_iters, self.ctrl)
        self.num_launches = 0

    def _run_block(self, pc: int) -> None:
        """One block on the static state: its tasks, the condition index
        into ``ctrl[2]`` as it is (the advance kernel routes an index out
        of range to STOP), and every leaf of the result copied back into
        the static buffers."""
        m = self.machine
        chain = m.blocks[pc]
        state = self.static.tree()
        for n in chain[:-1]:
            state = n.fn(state)
        term = chain[-1]
        if term.kind == "cond":
            idx, state = term.fn(state)
            if isinstance(idx, torch.Tensor) and idx.device.type != "cpu":
                self.ctrl[2].copy_(idx.reshape(()))
            else:   # a host constant, baked into the graph as jit would
                self.ctrl[2].fill_(int(idx))
        else:
            state = term.fn(state)
        _check_carry(self.static.sig, state, chain)
        out = pytree.tree_flatten(state)[0]
        # a leaf that aliases another static buffer (a swap, a view) is
        # cloned before any buffer is overwritten
        src = [t if t is buf or t.untyped_storage().data_ptr()
               not in self._storages else t.clone()
               for t, buf in zip(out, self.static.bufs)]
        for t, buf in zip(src, self.static.bufs):
            if t is not buf:
                buf.copy_(t)

    def nodes(self) -> int:
        """Nodes of the whole program, counted through the WHILE body, the
        IF bodies and the blocks' graphs."""
        return self.program.nodes()

    def __call__(self, state: Any) -> Any:
        self.static.fill(state)
        if torch.cuda.is_current_stream_capturing():
            self.program.nest()
        else:
            self.program.launch()
        self.num_launches += 1
        return self.static.tree([t.clone() for t in self.static.bufs])

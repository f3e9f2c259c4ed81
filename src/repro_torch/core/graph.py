"""Task dependency graph (TDG) model — paper §3.

Implements the five task types of the paper's unified programming model:

* **static**      — plain callable, no arguments (``tf.emplace(fn)``).
* **dynamic**     — callable taking a :class:`Subflow`; spawns a child TDG at
                    execution time, joined (default) or detached (§3.2).
* **composable**  — ``tf.composed_of(other_tf)`` module tasks (§3.3).
* **condition**   — callable returning an ``int`` index selecting which
                    successor to run; out-edges are *weak* dependencies
                    (§3.4). ``multi_condition`` returns a list of indices.
* **device (cudaFlow→DeviceFlow)** — callable taking a
                    :class:`repro_torch.core.deviceflow.DeviceFlow`;
                    records copies and kernels that are captured into ONE
                    CUDA graph and launched by one replay on the worker's
                    device (§3.5).

Strong vs weak dependencies (§3.4.1): an edge is *weak* iff its source is a
condition task. A node's join counter counts only strong in-edges; condition
tasks bypass the counter and schedule their selected successor directly —
this is what allows cycles and in-graph control flow.
"""
from __future__ import annotations

import enum
import inspect
import threading
from typing import Any, Callable, List, Optional, Sequence

__all__ = ["TaskType", "Node", "Task", "Taskflow", "Subflow", "GraphBuilder"]


class TaskType(enum.Enum):
    STATIC = "static"
    DYNAMIC = "dynamic"          # spawns a Subflow
    CONDITION = "condition"
    MULTI_CONDITION = "multi_condition"
    MODULE = "module"            # composed_of
    DEVICE = "device"            # DeviceFlow (cudaFlow analogue)


#: Default execution domains (paper Figure 8: CPU + GPU; generalizable).
HOST = "host"
ACCEL = "accel"


class Node:
    """A node in a TDG. Internal: users hold :class:`Task` handles."""

    __slots__ = (
        "name", "kind", "fn", "domain", "successors",
        "num_strong", "num_weak",
        # --- per-run state (owned by the executor) ---
        "_join", "_topology", "_parent", "_nested", "_graph",
        "module_target",
    )

    def __init__(self, fn: Optional[Callable], kind: TaskType, name: str,
                 domain: str, graph: "GraphBuilder") -> None:
        self.name = name
        self.kind = kind
        self.fn = fn
        self.domain = domain
        self.successors: List["Node"] = []
        self.num_strong = 0          # static count of strong in-edges
        self.num_weak = 0            # static count of weak in-edges
        self._join = 0               # runtime join counter (strong deps left)
        self._topology = None        # Topology of the current run
        self._parent: Optional["Node"] = None  # joining parent (subflow/module)
        self._nested = None          # AtomicInt latch while joining children
        self._graph = graph
        self.module_target: Optional["Taskflow"] = None

    # The executor re-arms the join counter at schedule time so that cyclic
    # graphs (condition-task loops) re-execute nodes with fresh counters.
    def is_source(self) -> bool:
        return self.num_strong == 0 and self.num_weak == 0

    def __repr__(self) -> str:  # pragma: no cover
        return f"Node({self.name!r}, {self.kind.value}, domain={self.domain})"


class Task:
    """Lightweight handle wrapping a node (paper §3.1)."""

    __slots__ = ("_node",)

    def __init__(self, node: Node) -> None:
        self._node = node

    # -- dependency building ---------------------------------------------------
    def precede(self, *tasks: "Task") -> "Task":
        """``self`` runs before each task in ``tasks``.

        If ``self`` is a condition task the edges are *weak*: the i-th call
        position defines the successor index returned by the condition.
        """
        src = self._node
        weak = src.kind in (TaskType.CONDITION, TaskType.MULTI_CONDITION)
        for t in tasks:
            dst = t._node
            src.successors.append(dst)
            if weak:
                dst.num_weak += 1
            else:
                dst.num_strong += 1
        return self

    def succeed(self, *tasks: "Task") -> "Task":
        for t in tasks:
            t.precede(self)
        return self

    # -- attributes --------------------------------------------------------------
    @property
    def name(self) -> str:
        return self._node.name

    def rename(self, name: str) -> "Task":
        self._node.name = name
        return self

    @property
    def kind(self) -> TaskType:
        return self._node.kind

    @property
    def domain(self) -> str:
        return self._node.domain

    def num_successors(self) -> int:
        return len(self._node.successors)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Task({self._node.name!r})"


def _looks_dynamic(fn: Callable) -> bool:
    """A callable taking a first parameter named ``sf``/``subflow`` is dynamic."""
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):
        return False
    return bool(params) and params[0].name in ("sf", "subflow")


class GraphBuilder:
    """Shared graph-construction API for Taskflow and Subflow (paper: the API
    used for one task type is nearly applicable to all the others)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self._nodes: List[Node] = []
        self._counter = 0
        self._inflight_topology = None  # live Topology guard (executor-owned)

    # -- creation -----------------------------------------------------------------
    def _add(self, fn: Optional[Callable], kind: TaskType, name: str,
             domain: str) -> Task:
        if not name:
            name = f"{kind.value}-{self._counter}"
        self._counter += 1
        node = Node(fn, kind, name, domain, self)
        self._nodes.append(node)
        return Task(node)

    def emplace(self, *fns: Callable, domain: str = HOST):
        """Create one task per callable (paper Listing 1). Infers *dynamic*
        tasks from a leading ``sf``/``subflow`` parameter (paper Listing 2)."""
        tasks = []
        for fn in fns:
            kind = TaskType.DYNAMIC if _looks_dynamic(fn) else TaskType.STATIC
            tasks.append(self._add(fn, kind, getattr(fn, "__name__", ""), domain))
        if len(tasks) == 1:
            return tasks[0]
        return tuple(tasks)

    def static(self, fn: Callable, name: str = "", domain: str = HOST) -> Task:
        return self._add(fn, TaskType.STATIC, name, domain)

    def dynamic(self, fn: Callable, name: str = "", domain: str = HOST) -> Task:
        return self._add(fn, TaskType.DYNAMIC, name, domain)

    def condition(self, fn: Callable, name: str = "", domain: str = HOST) -> Task:
        return self._add(fn, TaskType.CONDITION, name, domain)

    def multi_condition(self, fn: Callable, name: str = "",
                        domain: str = HOST) -> Task:
        return self._add(fn, TaskType.MULTI_CONDITION, name, domain)

    def device(self, fn: Callable, name: str = "", domain: str = ACCEL) -> Task:
        """cudaFlow: ``fn(deviceflow)`` records device ops that are
        captured into one CUDA graph and launched by one replay (paper
        §3.5)."""
        return self._add(fn, TaskType.DEVICE, name, domain)

    # -- introspection ---------------------------------------------------------------
    def num_tasks(self) -> int:
        return len(self._nodes)

    def empty(self) -> bool:
        return not self._nodes

    def tasks(self) -> Sequence[Task]:
        return [Task(n) for n in self._nodes]

    def dump(self) -> str:
        """GraphViz dot output (paper's ``Taskflow::dump``)."""
        lines = [f'digraph "{self.name or "taskflow"}" {{']
        for n in self._nodes:
            shape = "diamond" if n.kind in (TaskType.CONDITION,
                                            TaskType.MULTI_CONDITION) else "box"
            lines.append(f'  "{n.name}" [shape={shape}];')
            weak = n.kind in (TaskType.CONDITION, TaskType.MULTI_CONDITION)
            style = ' [style=dashed]' if weak else ""
            for s in n.successors:
                lines.append(f'  "{n.name}" -> "{s.name}"{style};')
        lines.append("}")
        return "\n".join(lines)


class Taskflow(GraphBuilder):
    """Top-level TDG: the gateway to create tasks and submit to an Executor."""

    def composed_of(self, other: "Taskflow", name: str = "") -> Task:
        """Module task (paper §3.3). The module keeps a *soft* mapping to
        ``other``; two module tasks of the same taskflow must not run
        concurrently (paper Figure 4)."""
        t = self._add(None, TaskType.MODULE, name or f"module-{other.name}",
                      HOST)
        t._node.module_target = other
        return t


class Subflow(GraphBuilder):
    """Child TDG spawned during execution of a dynamic task (paper §3.2)."""

    def __init__(self, parent: Node, name: str = "") -> None:
        super().__init__(name or f"subflow-of-{parent.name}")
        self._parent_node = parent
        self._detached = False
        self._joined = False

    def detach(self) -> None:
        """Let the subflow run independently; it joins at the end of the
        taskflow instead of at its parent (paper §3.2)."""
        if self._joined:
            raise RuntimeError("subflow already joined")
        self._detached = True

    @property
    def detached(self) -> bool:
        return self._detached

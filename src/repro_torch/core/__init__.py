"""repro_torch.core — the paper's task-graph system (host layer).

JAX-free copies of the reference host runtime:
    Taskflow / Task / Subflow       task-graph model (§3)
    Executor / Topology             heterogeneous work stealing (§4)
    EventNotifier / WorkStealingQueue  runtime data structures (§4.3)

The reference's device layer (``JaxGraph``, ``DeviceFlow``) is not ported
yet; a ``DEVICE`` task raises ``NotImplementedError``.
"""
from .atomic import AtomicInt
from .executor import Executor, TaskError, Topology
from .graph import ACCEL, HOST, GraphBuilder, Subflow, Task, Taskflow, TaskType
from .notifier import EventNotifier, Waiter
from .observer import Observer, Profiler
from .wsq import WorkStealingQueue

__all__ = [
    "AtomicInt", "Executor", "TaskError", "Topology",
    "ACCEL", "HOST", "GraphBuilder", "Subflow", "Task", "Taskflow",
    "TaskType", "EventNotifier", "Waiter",
    "Observer", "Profiler", "WorkStealingQueue",
]

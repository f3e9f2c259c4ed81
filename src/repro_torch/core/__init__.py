"""repro_torch.core — the paper's task-graph system.

Host layer (copies of the reference host runtime):
    Taskflow / Task / Subflow       task-graph model (§3)
    Executor / Topology             heterogeneous work stealing (§4)
    EventNotifier / WorkStealingQueue  runtime data structures (§4.3)
    algorithms                      parallel_for / reduce / pipeline

Device layer:
    DeviceFlow                      cudaFlow over a CUDA graph, one replay
                                    per launch (§3.5)
    CondGraph / STOP                in-graph conditional tasking (§3.4): a
                                    cyclic graph of state transformers as
                                    ONE CUDA graph with WHILE/IF nodes (the
                                    counterpart of ``JaxGraph``)
"""
from . import algorithms
from .atomic import AtomicInt
from .condgraph import STOP, CondGraph
from .deviceflow import DeviceFlow
from .executor import Executor, TaskError, Topology
from .graph import ACCEL, HOST, GraphBuilder, Subflow, Task, Taskflow, TaskType
from .notifier import EventNotifier, Waiter
from .observer import Observer, Profiler
from .wsq import WorkStealingQueue

__all__ = [
    "AtomicInt", "CondGraph", "DeviceFlow", "STOP", "Executor", "TaskError", "Topology",
    "ACCEL", "HOST", "GraphBuilder", "Subflow", "Task", "Taskflow",
    "TaskType", "EventNotifier", "Waiter",
    "Observer", "Profiler", "WorkStealingQueue", "algorithms",
]

"""Data-passing pipeline (Pipeflow's ``tf::DataPipeline``).

:class:`DataPipeline` owns one buffer per line and threads it through the
stages: the first pipe *produces* a value (``fn(pf) -> value``), every later
pipe *transforms* it (``fn(pf, value) -> value``). Because at most one slot
of a line is active at any time (the line's slots form a chain in the cyclic
grid), the per-line buffer needs **no lock** — the scheduling dependencies
are the synchronisation, exactly the Pipeflow argument for why task-parallel
pipelines need no queues between stages.
"""
from __future__ import annotations

from typing import Any, List

from .pipeline import Pipe, Pipeflow, Pipeline

__all__ = ["DataPipe", "DataPipeline"]


class DataPipe(Pipe):
    """A stage of a :class:`DataPipeline`.

    First stage: ``fn(pf) -> value`` (or ``pf.stop()``; the value is then
    discarded). Later stages: ``fn(pf, value) -> value``.
    """


class DataPipeline(Pipeline):
    def __init__(self, num_lines: int, *pipes: Pipe, name: str = "data-pipeline"):
        super().__init__(num_lines, *pipes, name=name)
        self._buffers: List[Any] = [None] * num_lines

    def buffer(self, line: int) -> Any:
        """The line's current value (after a run: the last stage's output)."""
        return self._buffers[line]

    def _invoke(self, pipe: Pipe, pf: Pipeflow) -> None:
        if pf.pipe == 0:
            out = pipe.fn(pf)
            if not pf._stopped and pf._defer_on is None:
                self._buffers[pf.line] = out
        else:
            self._buffers[pf.line] = pipe.fn(pf, self._buffers[pf.line])

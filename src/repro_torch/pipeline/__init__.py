"""repro_torch.pipeline — task-parallel pipeline scheduling (Pipeflow
style): JAX-free copies of the reference ``pipeline`` and ``data``
modules, built on the condition-task machinery of
:mod:`repro_torch.core`."""
from .data import DataPipe, DataPipeline
from .pipeline import Pipe, Pipeflow, Pipeline, PipeType

__all__ = ["DataPipe", "DataPipeline",
           "Pipe", "Pipeflow", "Pipeline", "PipeType"]

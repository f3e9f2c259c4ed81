"""Device resolution shared by the port's entry points: CUDA unless the
caller asks for another device, and no silent move to the CPU; and the
guard every CUDA-graph capture of the port runs under."""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

__all__ = ["resolve_device", "collection_paused"]

_PAUSE_LOCK = threading.Lock()
_pause_depth = 0
_pause_was_enabled = False


@contextlib.contextmanager
def collection_paused():
    """Keep the cyclic garbage collector off for the block (a CUDA-graph
    capture). A CUDA graph in a dead reference cycle destroyed by the
    collector while this thread captures calls a CUDA API that the
    capture refuses, and that invalidates the capture. Reentrant across
    threads (captures on executor workers overlap): the first block to
    enter turns the collector off, the last to leave turns it back on if
    it was on. The port's own graphs are released where they end
    (:meth:`repro_torch.serve.chunk_graph.ChunkProgram.release`,
    :meth:`repro_torch.core.deviceflow.DeviceFlow.close`), so none waits
    in a cycle for the collector."""
    global _pause_depth, _pause_was_enabled
    with _PAUSE_LOCK:
        if _pause_depth == 0:
            _pause_was_enabled = gc.isenabled()
            gc.disable()
        _pause_depth += 1
    try:
        yield
    finally:
        with _PAUSE_LOCK:
            _pause_depth -= 1
            if _pause_depth == 0 and _pause_was_enabled:
                gc.enable()


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA (device 0 or the current one) and raises when no
    CUDA device is present; anything else is taken as given (the tests pass
    ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:   # tensors report cuda:N, never bare cuda
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

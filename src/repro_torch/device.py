"""Device resolution shared by the port's entry points: CUDA unless the
caller asks for another device, and no silent move to the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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

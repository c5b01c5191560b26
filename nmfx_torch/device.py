"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA.

    Raises when CUDA is asked for (explicitly or by default) and no CUDA
    device is present: the port never carries on quietly on the CPU. The
    CPU runs only when the caller passes ``device="cpu"``.

    On CUDA this also switches TF32 off for float32 matmuls
    (``torch.backends.cuda.matmul.allow_tf32 = False``), so every plain
    product in the port runs in full float32. It is set here, when an
    entry point runs, never when the package is imported.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nmfx_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {dev}")
    return dev


def explicit_device(device: torch.device) -> torch.device:
    """``device`` with its index: a CUDA device without one names the
    calling thread's current card. Threads keep their own current
    device, so a device handed to another thread must carry its index."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def to_device(x, dtype, device) -> torch.Tensor:
    """A tensor or array-like as a ``dtype`` tensor on ``device`` (host
    arrays are copied, so read-only buffers are never aliased)."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)

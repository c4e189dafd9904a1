"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. With no GPU
present a CUDA request raises: nothing moves to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lupinpathtracer_tpu_torch: device 'cuda' requested but no CUDA "
            "GPU is available; pass device='cpu' to run the plain PyTorch "
            "path on the CPU"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def on_cpu(t: torch.Tensor) -> bool:
    """Where a kernel wrapper runs for tensor t: True on the CPU (the plain
    PyTorch version), False on a CUDA device (the kernel). Any other device
    raises: the plain version serves CPU tensors only."""

    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {t.device}")
    return kind == "cpu"

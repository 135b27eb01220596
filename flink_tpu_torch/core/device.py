"""The device an entry point runs on: ``None`` means the CUDA card, and a
machine without one raises instead of running somewhere else. Tests pass
``device="cpu"``, which runs every kernel's plain PyTorch version."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "flink_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch versions "
            "of the kernels"
        )
    return dev

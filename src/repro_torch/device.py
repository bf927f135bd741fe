"""The device rule of the port: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import torch

#: the device types on which a kernel's wrapper takes its plain version: the
#: CPU, and ``meta`` (shapes only: the dry run counts a step's FLOPs there).
#: A CUDA tensor always goes to the kernel.
PLAIN_DEVICES = ("cpu", "meta")


def resolve_device(device) -> torch.device:
    """The device a caller asked for. CUDA is the default everywhere; without
    a CUDA device that request fails here, loudly — nothing moves to the CPU
    unless the caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' to "
            "run the plain PyTorch version on the CPU"
        )
    return dev

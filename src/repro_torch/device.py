"""The device rule of the port: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib
import threading

import torch

#: the device types on which a kernel's wrapper takes its plain version: the
#: CPU, and ``meta`` (shapes only: the dry run counts a step's FLOPs there).
#: A CUDA tensor always goes to the kernel.
PLAIN_DEVICES = ("cpu", "meta")

_FOOTPRINT = threading.local()


@contextlib.contextmanager
def kernel_footprint():
    """Within it, a kernel's wrapper given ``meta`` tensors follows the
    card's path as far as memory goes: it allocates what the kernel returns
    (and its autograd Function saves what it saves on the card) instead of
    running the plain version, whose intermediates (attention's scores, the
    chunked WKV6 products) no kernel makes. ``analysis.memory`` counts a
    step's temporaries so; a FLOP count takes the plain version."""
    prev = getattr(_FOOTPRINT, "on", False)
    _FOOTPRINT.on = True
    try:
        yield
    finally:
        _FOOTPRINT.on = prev


def footprint(x: torch.Tensor) -> bool:
    """Whether a wrapper given ``x`` only allocates its kernel's outputs
    (``meta`` under ``kernel_footprint``)."""
    return x.device.type == "meta" and getattr(_FOOTPRINT, "on", False)


def plain_path(x: torch.Tensor) -> bool:
    """Whether a wrapper given ``x`` takes its kernel's plain version: on a
    device of ``PLAIN_DEVICES``, unless ``footprint``."""
    return x.device.type in PLAIN_DEVICES and not footprint(x)


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

"""Device resolution (≙ the reference serving replica's one-device
``Topology``, ``distributedmnist_tpu/servesvc/server.py`` — a lean
single-device placement that joins no collective).

The port runs on the GPU. An entry point that is handed no device
takes ``cuda:0``; on a machine without CUDA that is an error, never a
silent fall back to the CPU — a CPU run is only ever one the caller
asked for (``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(requested: str | torch.device | None = None
                   ) -> torch.device:
    """``None`` → ``cuda:0``; an explicit device is taken as given.

    Raises ``RuntimeError`` when a CUDA device is wanted (by default or
    by name) and CUDA is not available."""
    dev = torch.device("cuda:0" if requested is None else requested)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available "
                "on this machine; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev

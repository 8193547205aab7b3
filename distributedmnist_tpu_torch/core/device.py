"""Device resolution (≙ the reference serving replica's one-device
``Topology``, ``distributedmnist_tpu/servesvc/server.py`` — a lean
single-device placement that joins no collective).

The port runs on the GPU. An entry point that is handed no device
takes ``cuda:0`` — or ``cuda:$LOCAL_RANK`` in a process that
``torchrun`` started, one card per process; on a machine without CUDA
that is an error, never a silent fall back to the CPU — a CPU run is
only ever one the caller asked for (``device="cpu"``, as the tests
do). The train and eval steps
set cuDNN's policy for the span of each call (:func:`cudnn_policy`),
so building a model or a step changes no process-wide setting.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch


def resolve_device(requested: str | torch.device | None = None
                   ) -> torch.device:
    """``None`` → ``cuda:$LOCAL_RANK`` (``cuda:0`` when unset); an
    explicit device is taken as given.

    Raises ``RuntimeError`` when a CUDA device is wanted (by default or
    by name) and CUDA is not available."""
    if requested is None:
        requested = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    dev = torch.device(requested)
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


# cuDNN's flags are process-wide: two threads (a train step and the
# checkpoint writer's calibration predict, or a serving batcher) must not
# interleave their set-and-restore, or the later restore leaves the
# earlier thread's setting behind
_CUDNN_LOCK = threading.RLock()


@contextlib.contextmanager
def cudnn_policy(deterministic: bool, allow_tf32: bool | None = None):
    """cuDNN's settings for one step, restored on exit: only its
    deterministic algorithms when ``deterministic`` (a seeded run then
    repeats bit for bit, as the reference's does), and TF32 rounding of
    float32 convolutions as ``allow_tf32`` says (None leaves it). One
    thread at a time holds a policy."""
    cudnn = torch.backends.cudnn
    with _CUDNN_LOCK:
        saved = cudnn.deterministic, cudnn.allow_tf32
        cudnn.deterministic = deterministic
        if allow_tf32 is not None:
            cudnn.allow_tf32 = allow_tf32
        try:
            yield
        finally:
            cudnn.deterministic, cudnn.allow_tf32 = saved

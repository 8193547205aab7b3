"""The LeNet-style MNIST CNN (≙ ``distributedmnist_tpu/models/cnn.py``):
conv5x5x32 → ReLU → maxpool2 → conv5x5x64 → ReLU → maxpool2 → FC512
→ dropout (train only) → FC10.

Params keep the reference's layout — HWIO conv kernels, ``[in, out]``
dense weights, and ``fc1`` reading the NHWC flatten order — so a
checkpoint of either package loads in the other unchanged. The forward
converts inside itself: NHWC images to NCHW, HWIO kernels to OIHW, and
the pooled activations back to NHWC order before the flatten.

As in the reference, activations and products run in
``compute_dtype`` (bfloat16 by default) with the bias added after the
convolution in that dtype, params and the loss stay float32, and
dropout is inverted dropout drawn from an explicit key: the same
``bernoulli`` bits as the reference's on the same key
(:mod:`..core.prng`). ``init`` draws the reference's truncated normals
from ``PRNGKey(init_seed)`` split four ways, so a fresh run starts from
the reference's params bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng

Params = dict[str, Any]

HIDDEN = 512  # fc1's width: dropout's keep mask is [batch, HIDDEN]


def truncated_normal_init(key, shape, stddev: float = 0.1,
                          device=None) -> torch.Tensor:
    """N(0, stddev²) truncated to ±2σ (≙ ``truncated_normal_init``)."""
    return prng.truncated_normal(key, -2.0, 2.0, shape, device) * stddev


def init(key, image_size: int = 28, num_channels: int = 1,
         num_classes: int = 10, device=None) -> Params:
    """Float32 params on ``device`` from a ``uint32[2]`` key."""
    k1, k2, k3, k4 = prng.split(key, 4)
    fc_in = (image_size // 4) * (image_size // 4) * 64
    full = lambda n, v: torch.full((n,), v, dtype=torch.float32,
                                   device=device)
    return {
        "conv1": {"w": truncated_normal_init(k1, (5, 5, num_channels, 32),
                                             device=device),
                  "b": full(32, 0.0)},
        "conv2": {"w": truncated_normal_init(k2, (5, 5, 32, 64),
                                             device=device),
                  "b": full(64, 0.1)},
        "fc1": {"w": truncated_normal_init(k3, (fc_in, HIDDEN),
                                           device=device),
                "b": full(HIDDEN, 0.1)},
        "fc2": {"w": truncated_normal_init(k4, (HIDDEN, num_classes),
                                           device=device),
                "b": full(num_classes, 0.1)},
    }


def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` through a 5x5 "SAME" conv with HWIO ``w``, bias, ReLU
    and a 2x2/2 max-pool ("SAME": an odd edge pools a padded window)."""
    y = F.conv2d(x, w.permute(3, 2, 0, 1), padding=2)
    y = torch.relu(y + b[None, :, None, None])
    return F.max_pool2d(y, 2, 2, ceil_mode=True)


def dropout_mask(key, shape, rate: float, device=None) -> torch.Tensor:
    """The keep mask the reference draws: ``bernoulli(key, 1 - rate,
    shape)`` (a batch of keys ``[n, 2]`` gives ``[n, *shape]``)."""
    return prng.bernoulli(key, 1.0 - rate, shape, device)


def apply(params: Params, images: torch.Tensor, *, train: bool = False,
          dropout_keep: torch.Tensor | None = None,
          dropout_rate: float = 0.5,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Forward pass → float32 logits [batch, num_classes] from images
    [batch, H, W, C] in [-0.5, 0.5]. In training, dropout keeps
    ``dropout_keep`` (``[batch, HIDDEN]`` bool, :func:`dropout_mask`
    of the replica's key, drawn beforehand as the train step does for
    all replicas at once)."""
    p = {k: {n: t.to(compute_dtype) for n, t in v.items()}
         for k, v in params.items()}
    x = images.to(compute_dtype).permute(0, 3, 1, 2)
    x = _conv_relu_pool(x, p["conv1"]["w"], p["conv1"]["b"])
    x = _conv_relu_pool(x, p["conv2"]["w"], p["conv2"]["b"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
    x = torch.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
    if train and dropout_rate > 0.0:
        if dropout_keep is None:
            raise ValueError("train=True dropout requires dropout_keep")
        scale = float(np.float32(1.0 - dropout_rate))
        x = torch.where(dropout_keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    logits = x @ p["fc2"]["w"] + p["fc2"]["b"]
    return logits.float()


def loss_fn(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sparse softmax cross-entropy."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy."""
    return (torch.argmax(logits, dim=-1) == labels.long()).float().mean()


def predictions(logits: torch.Tensor) -> torch.Tensor:
    """Softmax class probabilities [batch, num_classes]."""
    return torch.softmax(logits, dim=-1)

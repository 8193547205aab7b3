"""ResNet-20 for CIFAR-10 (≙ ``distributedmnist_tpu/models/resnet.py``):
a 3×3×16 stem, three stages of three basic blocks at widths 16/32/64
(each stage after the first opens with a stride-2 block and a 1×1
projection), GroupNorm (8 groups) instead of BatchNorm, a global average
pool and a dense head — 272,282 params at 32×32×3.

Params keep the reference's tree and layout: HWIO kernels, ``stages`` a
list of stages, each a list of block dicts (``proj`` only where the
width changes), norms ``{"scale", "bias"}``, the head ``{"w": [64,
classes], "b"}``. ``init`` draws ``split(key, 64)`` in the reference's
order (stem, then per block conv1, conv2 and proj, the head last) through
the port's threefry, so a seed gives the reference's params bit for bit.

The forward casts every param to ``compute_dtype`` first, as the
reference does, and runs NCHW inside: the images are permuted once and
the kernels per call. The convolutions pad as XLA's ``"SAME"`` does,
which for a stride-2 3×3 convolution on an even size is ``(0, 1)`` —
not ``padding=1`` (:func:`same_pads`). GroupNorm normalizes in float32
over each group of consecutive channels with the compute-dtype-rounded
scale and bias, and casts back to the compute dtype once.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from .cnn import truncated_normal_init

Params = dict[str, Any]

WIDTHS = (16, 32, 64)
BLOCKS_PER_STAGE = 3  # 3 stages × 3 blocks × 2 convs + stem + head = 20
GROUPS = 8


def _conv_init(key, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """He-style fan-out truncated normal; the stddev is the reference's
    float32 ``sqrt(2 / fan_out)``."""
    fan_out = shape[0] * shape[1] * shape[3]
    stddev = float(np.sqrt(np.float32(2.0 / fan_out)))
    return truncated_normal_init(key, shape, stddev=stddev, device=device)


def _norm_init(ch: int, device=None) -> Params:
    return {"scale": torch.ones(ch, dtype=torch.float32, device=device),
            "bias": torch.zeros(ch, dtype=torch.float32, device=device)}


def init(key, num_classes: int = 10, num_channels: int = 3,
         device=None) -> Params:
    """Float32 params on ``device`` from a ``uint32[2]`` key."""
    keys = iter(prng.split(key, 64))
    params: Params = {
        "stem": {"w": _conv_init(next(keys), (3, 3, num_channels, WIDTHS[0]),
                                 device)},
        "stem_norm": _norm_init(WIDTHS[0], device),
        "stages": [],
    }
    in_ch = WIDTHS[0]
    for width in WIDTHS:
        stage = []
        for _ in range(BLOCKS_PER_STAGE):
            block = {
                "conv1": {"w": _conv_init(next(keys), (3, 3, in_ch, width),
                                          device)},
                "norm1": _norm_init(width, device),
                "conv2": {"w": _conv_init(next(keys), (3, 3, width, width),
                                          device)},
                "norm2": _norm_init(width, device),
            }
            if in_ch != width:
                block["proj"] = {"w": _conv_init(next(keys),
                                                 (1, 1, in_ch, width), device)}
            stage.append(block)
            in_ch = width
        params["stages"].append(stage)
    params["head"] = {
        "w": truncated_normal_init(next(keys), (WIDTHS[-1], num_classes),
                                   stddev=0.1, device=device),
        "b": torch.zeros(num_classes, dtype=torch.float32, device=device),
    }
    return params


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis: ``(low, high)`` with
    the odd element on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW ``x`` through a ``"SAME"`` convolution with HWIO ``w``."""
    kh, kw = w.shape[0], w.shape[1]
    ph = same_pads(x.shape[-2], kh, stride)
    pw = same_pads(x.shape[-1], kw, stride)
    w = w.permute(3, 2, 0, 1)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _group_norm(x: torch.Tensor, p: Params,
                groups: int = GROUPS) -> torch.Tensor:
    """GroupNorm of NCHW ``x`` in float32 (population variance, eps
    1e-5) with the given scale and bias, cast back to ``x``'s dtype."""
    g = min(groups, x.shape[1])
    out = F.group_norm(x.float(), g, p["scale"].float(), p["bias"].float(),
                       eps=1e-5)
    return out.to(x.dtype)


def apply(params: Params, images: torch.Tensor, *, train: bool = False,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Float32 logits ``[batch, classes]`` from NHWC images in
    [-0.5, 0.5]. ``train`` changes nothing (no dropout, no batch
    statistics)."""
    del train
    p = _cast(params, compute_dtype)
    x = images.to(compute_dtype).permute(0, 3, 1, 2)
    x = torch.relu(_group_norm(_conv(x, p["stem"]["w"]), p["stem_norm"]))
    for si, stage in enumerate(p["stages"]):
        for bi, block in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            h = _conv(x, block["conv1"]["w"], stride)
            h = torch.relu(_group_norm(h, block["norm1"]))
            h = _group_norm(_conv(h, block["conv2"]["w"]), block["norm2"])
            if "proj" in block:
                x = _conv(x, block["proj"]["w"], stride)
            x = torch.relu(x + h)
    x = x.mean(dim=(2, 3))  # global average pool
    logits = x @ p["head"]["w"] + p["head"]["b"]
    return logits.float()


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)

"""Drop-connect gradient masking (≙ ``distributedmnist_tpu/ops/
drop_connect.py``): each gradient element is multiplied by an
independent Bernoulli(keep_prob) draw before aggregation, with no
``1/keep_prob`` rescale (the expected gradient is attenuated, as in
the reference). Leaf i draws from ``split(key, n_leaves)[i]``, so the
masks are the reference's, bit for bit.
"""

from __future__ import annotations

import torch

from ..core import prng


def leaf_keys(key, n_leaves: int):
    """``[n_leaves, 2]``: leaf i's key, ``split(key, n_leaves)[i]`` (on
    the host)."""
    return prng.split(key, n_leaves)


def mask_leaves(leaves: list[torch.Tensor], keys,
                keep_prob: float) -> list[torch.Tensor]:
    """Mask leaf i with a draw from ``keys[i]`` (host keys, or an int64
    tensor of them on the leaves' device)."""
    return [g * prng.bernoulli(k, keep_prob, g.shape, g.device).to(g.dtype)
            for g, k in zip(leaves, keys)]


def drop_connect_grads(leaves: list[torch.Tensor], key,
                       keep_prob: float) -> list[torch.Tensor]:
    """Mask every gradient leaf (in the params' leaf order)."""
    return mask_leaves(leaves, leaf_keys(key, len(leaves)), keep_prob)

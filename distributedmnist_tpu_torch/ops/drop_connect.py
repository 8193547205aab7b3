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


def drop_connect_grads(leaves: list[torch.Tensor], key,
                       keep_prob: float) -> list[torch.Tensor]:
    """Mask every gradient leaf (in the params' leaf order)."""
    keys = prng.split(key, len(leaves))
    return [g * prng.bernoulli(k, keep_prob, g.shape, g.device).to(g.dtype)
            for g, k in zip(leaves, keys)]

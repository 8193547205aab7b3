"""Carry weights between the reference's param tree and the port's.

The reference keeps a transformer's params as a pytree of arrays:
``{"embed", "pos", "blocks", "final_norm"}`` with ``blocks`` a list of
per-layer dicts — or, in a checkpoint's flax state-dict form, a dict
keyed ``"0"``, ``"1"``, ... The port keeps the same layout as torch
tensors with ``blocks`` a list. Both directions copy leaf for leaf; no
array is transposed or renamed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.device import resolve_device


def _blocks_list(blocks: Any) -> list:
    if isinstance(blocks, dict):  # flax state-dict form {"0": ..., ...}
        return [blocks[str(i)] for i in range(len(blocks))]
    return list(blocks)


def params_from_reference(tree: dict, *, device=None,
                          dtype: torch.dtype | None = None) -> dict:
    """Reference params (numpy, or anything ``np.asarray`` takes) → the
    port's params on ``device`` (default ``cuda:0``), cast to ``dtype``
    when given."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x)
        # a checkpoint's leaves are read-only views of the file bytes
        a = np.array(a) if not a.flags.writeable else np.ascontiguousarray(a)
        t = torch.from_numpy(a)
        return t.to(device=dev, dtype=dtype or t.dtype)

    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [conv(b) for b in _blocks_list(tree["blocks"])]
    return out


def params_to_reference(params: dict) -> dict:
    """The port's params → the reference's layout as numpy arrays
    (``blocks`` a list, as the reference's ``init`` builds it). Floating
    leaves in a dtype numpy lacks (bfloat16) come back as float32."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return conv(params)

"""Carry weights and training state between the reference's trees and
the port's.

The reference keeps a transformer's params as a pytree of arrays:
``{"embed", "pos", "blocks", "final_norm"}`` with ``blocks`` a list of
per-layer dicts — or, in a checkpoint's flax state-dict form, a dict
keyed ``"0"``, ``"1"``, ... The CNN's is ``{"conv1", "conv2", "fc1",
"fc2"}`` of ``{"w", "b"}`` (HWIO kernels, ``[in, out]`` dense), which
the port keeps as is. The port keeps each layout as torch tensors with
``blocks`` a list. Both directions copy leaf for leaf; no array is
transposed or renamed.

:func:`state_from_reference` / :func:`state_to_reference` carry a whole
``TrainState`` (params, momentum slots and counters) the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.device import resolve_device

# The reference TrainState's fields, in its order (parallel/api.py).
STATE_FIELDS = ("params", "momentum", "step", "updates_applied",
                "root_key", "window_acc", "window_rounds", "wall_ms",
                "next_apply_ms")


def _blocks_list(blocks: Any) -> list:
    if isinstance(blocks, dict):  # flax state-dict form {"0": ..., ...}
        return [blocks[str(i)] for i in range(len(blocks))]
    return list(blocks)


def params_from_reference(tree: dict, *, device=None,
                          dtype: torch.dtype | None = None) -> dict:
    """Reference params (numpy, or anything ``np.asarray`` takes) → the
    port's params on ``device`` (default ``cuda:0``), cast to ``dtype``
    when given. Torch leaves (a bf16 tier's words) are moved as they
    are, so a quant tier's tree converts the same way."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype or x.dtype)
        a = np.asarray(x)
        # a checkpoint's leaves are read-only views of the file bytes
        a = np.array(a) if not a.flags.writeable else np.ascontiguousarray(a)
        t = torch.from_numpy(a)
        return t.to(device=dev, dtype=dtype or t.dtype)

    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    if "blocks" in tree:
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


def _state_dict(state: Any) -> dict:
    if dataclasses.is_dataclass(state):  # the reference's TrainState
        return {f: getattr(state, f) for f in STATE_FIELDS}
    return dict(state)


def state_from_reference(state: Any, *, device=None):
    """A reference ``TrainState`` (its leaves as numpy, e.g. after
    ``jax.device_get``) or a checkpoint's state dict → the port's
    :class:`~..parallel.api.TrainState` on ``device`` (default
    ``cuda:0``). Params and momentum slots keep their dtypes (float32);
    the counters become Python numbers, ``root_key`` the raw
    ``uint32[2]``.

    Raises ``NotImplementedError`` for state the port cannot run: LAMB's
    ``{"m", "v"}`` slots."""
    from ..parallel.api import TrainState
    d = _state_dict(state)
    dev = resolve_device(device)
    mom = d.get("momentum")
    if isinstance(mom, dict) and set(mom) == {"m", "v"}:
        raise NotImplementedError("LAMB optimizer state is not ported yet")
    acc = d.get("window_acc")
    f32 = lambda k, default: float(np.float32(d.get(k, default)))
    return TrainState(
        params=params_from_reference(d["params"], device=dev),
        momentum=(None if mom is None
                  else params_from_reference(mom, device=dev)),
        step=int(d.get("step", 0)),
        updates_applied=int(d.get("updates_applied", d.get("step", 0))),
        root_key=np.array(d.get("root_key", (0, 0)), np.uint32),
        window_acc=(None if acc is None
                    else params_from_reference(acc, device=dev)),
        window_rounds=f32("window_rounds", 0.0),
        wall_ms=f32("wall_ms", 0.0),
        next_apply_ms=f32("next_apply_ms", 1000.0))


def state_to_reference(state) -> dict:
    """The port's TrainState → the reference's state dict as numpy (the
    layout a checkpoint stores: 0-d int32/float32 counters, ``blocks``
    a list that the writer keys by index)."""
    return {
        "params": params_to_reference(state.params),
        "momentum": (None if state.momentum is None
                     else params_to_reference(state.momentum)),
        "step": np.asarray(state.step, np.int32),
        "updates_applied": np.asarray(state.updates_applied, np.int32),
        "root_key": np.asarray(state.root_key, np.uint32),
        "window_acc": (None if state.window_acc is None
                       else params_to_reference(state.window_acc)),
        "window_rounds": np.asarray(state.window_rounds, np.float32),
        "wall_ms": np.asarray(state.wall_ms, np.float32),
        "next_apply_ms": np.asarray(state.next_apply_ms, np.float32),
    }

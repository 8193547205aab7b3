"""Carry weights and training state between the reference's trees and
the port's.

The reference keeps a transformer's params as a pytree of arrays:
``{"embed", "pos", "blocks", "final_norm"}`` with ``blocks`` a list of
per-layer dicts. ResNet-20's ``stages`` is a list of stages, each a
list of block dicts. In a checkpoint's flax state-dict form every list
is a dict keyed ``"0"``, ``"1"``, ... The CNN's is ``{"conv1", "conv2",
"fc1", "fc2"}`` of ``{"w", "b"}`` (HWIO kernels, ``[in, out]`` dense).
A mixture-of-experts block adds ``router [d, E]`` and stacks its experts
as ``w1 [E, d, 4d]``, ``w2 [E, 4d, d]``. The port keeps each layout as
torch tensors with lists as lists. Both directions copy leaf for leaf;
no array is transposed or renamed.

:func:`state_from_reference` / :func:`state_to_reference` carry a whole
``TrainState`` (params, optimizer slots and counters) the same way; the
slots are ``None``, one params-shaped tree, or LAMB's ``{"m": tree,
"v": tree}``.

:func:`shard_params` / :func:`gather_params` carry a full tree (the
reference's, or a checkpoint's) to one rank's shard along one mesh axis
(the model axis, or the expert axis of an MoE block's experts) and the
ranks' shards back, by a partition-rule table
(``parallel/partition_rules.py``); a rank of both axes takes its shard
of one, then of the other.
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


def _is_list_dict(x: Any) -> bool:
    """A list in flax state-dict form: a non-empty dict keyed "0".."k-1"
    (no param tree of the port's models keys a dict that way)."""
    return (isinstance(x, dict) and bool(x)
            and set(x) == {str(i) for i in range(len(x))})


def list_form(tree: Any) -> Any:
    """A tree with its state-dict lists (index-keyed dicts) back as
    lists; leaves untouched."""
    if _is_list_dict(tree):
        return [list_form(tree[str(i)]) for i in range(len(tree))]
    if isinstance(tree, dict):
        return {k: list_form(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [list_form(v) for v in tree]
    return tree


def params_from_reference(tree: dict, *, device=None,
                          dtype: torch.dtype | None = None) -> dict:
    """Reference params (numpy, or anything ``np.asarray`` takes) → the
    port's params on ``device`` (default ``cuda:0``), cast to ``dtype``
    when given; lists, or their state-dict form, become lists. Torch
    leaves (a bf16 tier's words) are moved as they are, so a quant
    tier's tree converts the same way."""
    dev = resolve_device(device)

    def conv(x):
        if _is_list_dict(x):
            return [conv(x[str(i)]) for i in range(len(x))]
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype or x.dtype)
        a = np.asarray(x)
        # a checkpoint's leaves are read-only views of the file bytes
        a = np.array(a) if not a.flags.writeable else np.ascontiguousarray(a)
        t = torch.from_numpy(a)
        return t.to(device=dev, dtype=dtype or t.dtype)

    return conv(tree)


def params_to_reference(params: Any, keep_bfloat16: bool = False) -> Any:
    """The port's params → the reference's layout as numpy arrays (lists
    as lists, as the reference's ``init`` builds them). A bfloat16 leaf,
    a dtype numpy lacks, comes back as float32 — or, with
    ``keep_bfloat16``, as a CPU torch ``bfloat16`` tensor of the same
    words, which the checkpoint writer packs as the reference packs its
    bf16 arrays."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t if keep_bfloat16 else t.float().numpy()
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
    ``cuda:0``). Params and slots keep their dtypes (a checkpoint's bf16
    params arrive widened to float32, exactly); LAMB's ``{"m", "v"}``
    slots stay a dict of two trees; the counters become Python numbers,
    ``root_key`` the raw ``uint32[2]``."""
    from ..parallel.api import TrainState
    d = _state_dict(state)
    dev = resolve_device(device)
    mom = d.get("momentum")
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
    layout a checkpoint stores: 0-d int32/float32 counters, lists that
    the writer keys by index, bf16 params as CPU bf16 tensors)."""
    return {
        "params": params_to_reference(state.params, keep_bfloat16=True),
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


def shard_params(tree: Any, rules: list, rank: int, m: int,
                 axis: str = "model") -> Any:
    """Rank ``rank``'s shard (of ``m``) along ``axis`` of the full
    ``tree`` (numpy arrays or tensors; lists, or their state-dict form):
    each leaf cut along the dim its rule splits over ``axis``
    (views)."""
    from ..parallel.partition_rules import (map_leaves,
                                            match_partition_rules,
                                            shard_leaf)
    tree = list_form(tree)
    specs = match_partition_rules(rules, tree)
    return map_leaves(lambda x, spec: shard_leaf(x, spec, axis, rank, m),
                      tree, specs)


def gather_params(shards: list, rules: list, axis: str = "model") -> Any:
    """The inverse of :func:`shard_params`: the ``m`` ranks' shards, in
    rank order, joined into the full tree."""
    from ..parallel.partition_rules import (gather_leaf, map_leaves,
                                            match_partition_rules)
    shards = [list_form(t) for t in shards]
    specs = match_partition_rules(rules, shards[0])
    return map_leaves(lambda first, spec, *rest: gather_leaf(
        [first, *rest], spec, axis), shards[0], specs, *shards[1:])

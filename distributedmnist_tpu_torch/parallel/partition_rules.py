"""Declarative partition rules and the ZeRO-1 shard plan (≙
``distributedmnist_tpu/parallel/partition_rules.py``).

**The rule engine** (:func:`match_partition_rules`, the reference's
``:48-113``) maps an ordered list of ``(regex on the "/"-joined leaf
path, spec)`` rules over a param tree: first match wins, a scalar leaf
is never split, and a leaf no rule covers is an
:class:`UnmatchedLeafError`. A spec is a tuple with one entry a dim:
an axis name (that dim is split over the axis) or None (whole); ``()``
is replicated — the reference's ``PartitionSpec``. The port runs the
model axis (tensor parallelism) and the expert axis (an MoE block's
experts): :func:`shard_leaf` / :func:`gather_leaf` cut a leaf to one
rank's block along the dim an axis splits and put the blocks back. The
tables live with the models (``models/registry.py``).

**The ZeRO-1 plan**: which leaves' optimizer state (and, under
``parallel.resident_sharded``, params) split over the ``n`` replicas,
their padded flat layout, and the layer-ordered communication buckets.
A leaf splits over the replicas only when its spec is replicated on
every other axis (:func:`spec_is_replicated`): a leaf the rule engine
splits over the model, stage or expert axis keeps its shard and its
placement and takes the replicated update (the reference's rule,
``partition_rules.py:179``).

A sharded leaf of ``size`` elements lives flattened and zero-padded to
``pad = chunk·n`` elements, ``chunk = ceil(size / n)``; replica ``r``
owns elements ``[r·chunk, (r+1)·chunk)``. A replicated leaf shards when
it has at least ``max(n, min_leaf_size or n)`` elements; a smaller one
keeps its logical shape and takes the replicated update. Leaves are indexed in
``tree_leaves`` order (dict keys sorted, lists in order), the
reference's ``jax.tree.leaves`` order.

:func:`zero1_pack` / :func:`zero1_unpack` move a tree between logical
shapes and the plan's ``[pad]`` layout on the host (numpy), as the
checkpoint contract needs: artifacts hold logical shapes whatever the
live layout, and a restore repacks for the current replica count,
re-padding a foreign world's flat leaf exactly (its padding is zeros;
a non-zero tail is refused).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Sequence

import numpy as np
import torch

# One rule: (regex searched in the "/"-joined leaf path, spec). Ordered;
# the first match wins.
Spec = tuple
Rule = tuple[str, Spec]


class UnmatchedLeafError(ValueError):
    """A param leaf no partition rule covers. Deliberately loud: an
    incomplete table must fail at build time, not silently replicate."""


@dataclasses.dataclass(frozen=True)
class RuleAxes:
    """The mesh axes a rule table may reference; None: that form of
    parallelism is inactive and the table leaves those dims whole."""

    model: str | None = None
    expert: str | None = None
    stage: str | None = None


def tree_path_names(tree: Any) -> list[str]:
    """The "/"-joined leaf paths of ``tree`` (``blocks/0/wqkv``), in
    :func:`tree_leaves` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [f"{k}/{p}" if p else str(k) for k in sorted(tree)
                for p in tree_path_names(tree[k]) or [""]
                if tree[k] is not None]
    if isinstance(tree, (list, tuple)):
        return [f"{i}/{p}" if p else str(i) for i, v in enumerate(tree)
                for p in tree_path_names(v) or [""]]
    return [""]


def _leaf_size(leaf: Any) -> int:
    shape = tuple(getattr(leaf, "shape", ()))
    return math.prod(int(d) for d in shape) if shape else 1


def match_partition_rules(rules: Sequence[Rule], tree: Any) -> Any:
    """A tree shaped like ``tree`` with a spec a leaf: the first rule
    whose regex ``re.search``-matches the leaf's path; ``()`` for a
    scalar or single-element leaf before any rule is read; a leaf no
    rule matches raises :class:`UnmatchedLeafError` naming its path."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def walk(node, path):
        if node is None:
            return None
        join = lambda k: f"{path}/{k}" if path else str(k)  # noqa: E731
        if isinstance(node, dict):
            return {k: walk(v, join(k)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, join(i)) for i, v in enumerate(node)]
        if _leaf_size(node) <= 1:
            return ()
        for pat, spec in compiled:
            if pat.search(path) is not None:
                return tuple(spec)
        raise UnmatchedLeafError(
            f"no partition rule matches param leaf {path!r} (shape "
            f"{tuple(getattr(node, 'shape', ()))}); rules: "
            f"{[pat for pat, _ in rules]}")
    return walk(tree, "")


def spec_leaves(specs: Any) -> list[Spec]:
    """The specs of a :func:`match_partition_rules` tree in
    :func:`tree_leaves` order (a spec is a tuple, and a leaf)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def split_dim(spec: Spec, axis: str | None) -> int | None:
    """The dim ``spec`` splits over ``axis``, or None."""
    if axis is None:
        return None
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        if axis in names:
            return d
    return None


def spec_is_replicated(spec: Spec) -> bool:
    """Whether ``spec`` splits no dim over any axis."""
    return all(entry is None for entry in tuple(spec))


def shard_leaf(x: Any, spec: Spec, axis: str | None, rank: int,
               size: int) -> Any:
    """Rank ``rank``'s block of ``x`` (a tensor or array) along the dim
    ``spec`` splits over ``axis``, out of ``size`` equal blocks (a view;
    ``x`` itself when nothing splits)."""
    d = split_dim(spec, axis)
    if d is None or size == 1:
        return x
    n = int(x.shape[d])
    if n % size:
        raise ValueError(f"dim {d} of size {n} is not divisible by the "
                         f"{axis!r} axis' size {size}")
    w = n // size
    index = [slice(None)] * len(x.shape)
    index[d] = slice(rank * w, (rank + 1) * w)
    return x[tuple(index)]


def gather_leaf(blocks: Sequence, spec: Spec, axis: str | None) -> Any:
    """The inverse of :func:`shard_leaf`: every rank's block, in rank
    order, joined along the split dim (numpy arrays or tensors)."""
    d = split_dim(spec, axis)
    if d is None:
        return blocks[0]
    if isinstance(blocks[0], torch.Tensor):
        return torch.cat(list(blocks), dim=d)
    return np.concatenate([np.asarray(b) for b in blocks], axis=d)


@dataclasses.dataclass(frozen=True)
class LeafShardPlan:
    """One leaf's decision: ``sharded`` leaves live as ``[pad]`` flat
    arrays split into ``n`` chunks of ``chunk`` elements; the others keep
    their logical ``shape``."""

    sharded: bool
    size: int
    pad: int
    chunk: int
    shape: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Zero1Plan:
    """``leaf_plans`` mirrors the param tree with a :class:`LeafShardPlan`
    a leaf; ``comm_buckets`` is the requested bucket count (the effective
    count is clamped to the sharded leaves, :func:`comm_bucket_assignment`)
    and ``params_sharded`` the resident-sharded layout."""

    n: int
    leaf_plans: Any
    comm_buckets: int = 1
    params_sharded: bool = False

    def leaves(self) -> list[LeafShardPlan]:
        return tree_leaves(self.leaf_plans)

    @property
    def any_sharded(self) -> bool:
        return any(lp.sharded for lp in self.leaves())


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``
    (dicts and lists; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves of a nest of dicts and lists in ``jax.tree.leaves`` order
    (dict keys sorted, list order); ``None`` has none. Per-leaf draws
    (drop-connect's ``split(key, n_leaves)``) and the plan's leaf indices
    follow this order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def make_zero1_plan(params: Any, param_specs: Any, n: int,
                    min_leaf_size: int = 0, comm_buckets: int = 1,
                    params_sharded: bool = False) -> Zero1Plan:
    """The plan of ``params`` (logical shapes, the stacked layout under
    pipeline parallelism; tensors or arrays, only shapes are read) over
    ``n`` replicas, with ``param_specs`` the rule engine's spec a leaf
    (:func:`match_partition_rules`; None: every leaf replicated). A leaf
    shards only when its spec is replicated. ``min_leaf_size`` 0 means
    ``n``: a leaf smaller than the replica count cannot give every
    replica a slice."""
    floor = max(n, min_leaf_size or n)

    def leaf_plan(p: Any, spec: Spec) -> LeafShardPlan:
        shape = tuple(int(d) for d in p.shape)
        size = math.prod(shape)
        chunk = -(-size // n)
        return LeafShardPlan(
            sharded=bool(spec_is_replicated(spec) and size >= floor
                         and n > 1),
            size=size, pad=chunk * n, chunk=chunk, shape=shape)

    if param_specs is None:
        param_specs = map_leaves(lambda _: (), params)
    return Zero1Plan(n=n, leaf_plans=map_leaves(leaf_plan, params,
                                                param_specs),
                     comm_buckets=max(1, int(comm_buckets)),
                     params_sharded=bool(params_sharded))


def comm_bucket_assignment(plan: Zero1Plan) -> list[list[int]]:
    """The sharded leaves' indices in ``comm_buckets`` contiguous groups
    balanced by padded size (the reference's rule: a leaf goes to the
    bucket its start falls in, and no bucket is left empty); empty when
    nothing shards."""
    lps = plan.leaves()
    sharded = [i for i, lp in enumerate(lps) if lp.sharded]
    if not sharded:
        return []
    k = max(1, min(int(plan.comm_buckets), len(sharded)))
    total = float(sum(lps[i].pad for i in sharded))
    buckets: list[list[int]] = [[] for _ in range(k)]
    cum, b = 0.0, 0
    for pos, i in enumerate(sharded):
        while (b < k - 1 and buckets[b]
               and (cum >= (b + 1) * total / k
                    or len(sharded) - pos <= k - b - 1)):
            b += 1
        buckets[b].append(i)
        cum += lps[i].pad
    return buckets


def zero1_init_state(params: Any, plan: Zero1Plan,
                     dtype_fn: Callable[[torch.dtype], torch.dtype]
                     | None = None, count: int | None = None) -> Any:
    """A zero slot tree in the plan's layout, on the params' devices: a
    sharded leaf holds ``count`` replicas' chunks (all ``n`` by default:
    ``[pad]``), a fallback leaf its logical shape. ``dtype_fn(param
    dtype) -> slot dtype`` (default: the param's)."""
    dt = dtype_fn or (lambda d: d)
    count = plan.n if count is None else count
    return map_leaves(lambda p, lp: torch.zeros(
        (count * lp.chunk,) if lp.sharded else tuple(p.shape),
        dtype=dt(p.dtype), device=p.device), params, plan.leaf_plans)


def _logical_flat(a: np.ndarray, lp: LeafShardPlan) -> np.ndarray:
    """A leaf's ``size`` logical elements, flat, from its logical shape
    or from a flat layout zero-padded for any replica count (a non-zero
    tail, or any other shape, is refused)."""
    flat = a.reshape(-1)
    if flat.size != lp.size:
        if a.ndim != 1 or flat.size < lp.size:
            raise ValueError(
                f"cannot pack leaf of shape {a.shape} into shard plan "
                f"(logical {lp.shape}, {lp.size} elements, pad {lp.pad})")
        if np.any(flat[lp.size:]):
            raise ValueError(
                f"flat leaf of size {flat.size} carries non-zero data past "
                f"the logical {lp.size} elements — not a zero-padded shard "
                "layout; refusing to truncate")
        flat = flat[:lp.size]
    return flat


def zero1_pack(tree: Any, plan: Zero1Plan) -> Any:
    """Logical-shape tree (numpy) → the plan's ``[pad]`` layout for its
    sharded leaves. A leaf already ``[pad]`` passes; a flat leaf padded
    for another replica count is truncated to its logical size — only
    when the tail is zeros — and re-padded."""
    def pack(x: Any, lp: LeafShardPlan):
        if not lp.sharded:
            return x
        a = np.asarray(x)
        if a.shape == (lp.pad,):
            return a
        flat = _logical_flat(a, lp)
        if lp.pad != flat.size:
            flat = np.concatenate([flat, np.zeros(lp.pad - flat.size,
                                                  a.dtype)])
        return flat
    return map_leaves(pack, tree, plan.leaf_plans)


def zero1_logical(tree: Any, plan: Zero1Plan) -> Any:
    """Every leaf of ``tree`` (numpy) in its logical shape, whether the
    plan shards it or not: a flat leaf zero-padded for any replica count
    (a per-host checkpoint's) is cut to its size and reshaped."""
    def logical(x: Any, lp: LeafShardPlan):
        a = np.asarray(x)
        return a if a.shape == lp.shape else _logical_flat(a, lp).reshape(
            lp.shape)
    return map_leaves(logical, tree, plan.leaf_plans)


def zero1_unpack(tree: Any, plan: Zero1Plan) -> Any:
    """The plan's ``[pad]`` layout → logical shapes (numpy arrays or
    tensors: a tensor's result is a view of it)."""
    def unpack(x: Any, lp: LeafShardPlan):
        if not lp.sharded or tuple(x.shape) == lp.shape:
            return x
        return x.reshape(-1)[:lp.size].reshape(lp.shape)
    return map_leaves(unpack, tree, plan.leaf_plans)

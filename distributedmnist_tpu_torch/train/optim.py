"""Optimizers (≙ ``distributedmnist_tpu/train/optim.py``): ``sgd``,
``momentum`` and the layer-wise trust-ratio optimizers ``lars``
(arXiv:1708.03888) and ``lamb`` (arXiv:1904.00962) as per-leaf update
rules.

As in the reference, a leaf's update is computed in float32 and the new
value cast back to the leaf's storage dtype (a bf16 param without
master weights still takes its update in float32); slots are float32
(:func:`slot_dtype`). The update rule sees either a whole logical leaf
(the replicated update) or a flat region of one (the ZeRO-1 update,
``parallel/api.py``): the only cross-element quantity is a sum of
squares, which ``norm_reduce`` completes over the other processes'
regions (zero padding adds nothing to it); ``adapt`` (weight decay and
the trust ratio) comes from the leaf's logical rank, never from the
flat region's. The slot layout is the reference's: ``None`` for
stateless sgd, one params-shaped tree for momentum and LARS, ``{"m":
tree, "v": tree}`` for LAMB. The port updates params and slots in place
(the reference builds new arrays; its buffer donation reuses the memory
just the same).

Scalars round as the reference's weakly typed float32 ones do: a Python
float ``c`` in ``c * x`` enters as ``float32(c)``, ``1 - b1`` is formed
in double and then rounded, and LAMB's bias corrections ``b ** t`` are
float32 powers of the float32 ``b`` and ``t``, taken on the host (where
``t`` lives) by torch's scalar ``pow``, which gives XLA's values (numpy's
float32 ``power`` differs from them by an ulp at about a fifth of ``t``):
once a step, by :attr:`Optimizer.corrections`.

The per-step numbers an update reads — ``lr`` and LAMB's corrections —
may be Python floats or 0-d float32 tensors on the leaves' device. The
train step passes tensors, read from its device buffer, so a CUDA graph
of the update reads each step's values; the arithmetic is the same
float32 either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..core.config import ConfigError, OptimConfig

OPTIMIZER_NAMES = ("sgd", "momentum", "lars", "lamb")

# update_leaf(p, g, slots, lr, t, norm_reduce, adapt) -> new slots;
# writes the new p into p and the new slots into the slots. The
# arguments are the reference's (train/optim.py:194-207): ``t`` the
# 1-based update count (LAMB's bias corrections; or the corrections
# ``(1 - b1**t, 1 - b2**t)`` already made), ``norm_reduce``
# completing a 0-d sum of squares over the other processes' regions of
# a sharded leaf (identity for a whole leaf), ``adapt`` whether weight
# decay and the trust ratio apply. ``lr`` is a Python float holding a
# float32 value (the schedule's), so ``lr * g`` rounds as the
# reference's float32 product does (a 0-d float32 tensor rounds alike).
UpdateLeaf = Callable[..., tuple]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``corrections(t)`` gives LAMB's two bias corrections for the
    1-based update count ``t`` (host floats); None for the others."""

    kind: str
    num_slots: int
    update_leaf: UpdateLeaf
    corrections: Callable[[float], tuple[float, float]] | None = None


def validate(ocfg: OptimConfig) -> None:
    if ocfg.name not in OPTIMIZER_NAMES:
        raise ConfigError(
            f"unknown optimizer {ocfg.name!r}; valid: {list(OPTIMIZER_NAMES)}")
    if ocfg.name in ("lars", "lamb") and ocfg.momentum != 0.0:
        raise ConfigError(
            f"optim.momentum={ocfg.momentum} combined with "
            f"optim.name={ocfg.name!r}: trust-ratio optimizers own their "
            "momentum term (optim.beta1); set optim.momentum=0")
    if ocfg.name == "momentum" and ocfg.momentum <= 0.0:
        raise ConfigError(
            f"optim.name='momentum' with optim.momentum={ocfg.momentum}: "
            "the explicit momentum optimizer needs a positive coefficient "
            "(heavyball at 0 is exactly plain sgd — name that instead)")
    if ocfg.schedule not in ("exponential", "polynomial"):
        raise ConfigError(
            f"unknown optim.schedule {ocfg.schedule!r}; valid: "
            "['exponential', 'polynomial']")


def opt_state_kind(ocfg: OptimConfig) -> str:
    """``none`` (stateless), ``momentum``, ``lars`` or ``lamb`` — the
    optimizer-state identity a checkpoint carries. ``sgd`` with
    ``momentum > 0`` is heavyball momentum."""
    validate(ocfg)
    if ocfg.name == "sgd":
        return "momentum" if ocfg.momentum > 0.0 else "none"
    return ocfg.name


def saved_opt_state_kind(optim_dict: dict | None) -> str | None:
    """``opt_state_kind`` of a checkpoint's saved ``config.optim``."""
    if not isinstance(optim_dict, dict):
        return None
    name = optim_dict.get("name", "sgd")
    if name == "sgd":
        return "momentum" if optim_dict.get("momentum", 0.0) else "none"
    return str(name)


def slot_dtype(param_dtype: torch.dtype) -> torch.dtype:
    """A slot's dtype: float32 for any floating param."""
    return torch.float32 if param_dtype.is_floating_point else param_dtype


# -- slot trees (None | tree | {"m": tree, "v": tree}) -----------------------

_SLOT_KEYS = frozenset({"m", "v"})


def is_slot_dict(opt_state: Any) -> bool:
    """True for LAMB's two-slot ``{"m": tree, "v": tree}`` layout."""
    return isinstance(opt_state, dict) and set(opt_state) == _SLOT_KEYS


def map_slots(fn: Callable[[Any], Any], opt_state: Any) -> Any:
    """``fn`` over each params-shaped slot tree, keeping the layout."""
    if opt_state is None:
        return None
    if is_slot_dict(opt_state):
        return {k: fn(tree) for k, tree in opt_state.items()}
    return fn(opt_state)


def slot_trees(opt: "Optimizer", opt_state: Any) -> list:
    """The state as an ordered list of ``opt.num_slots`` trees."""
    if opt.num_slots == 0:
        return []
    if opt.num_slots == 1:
        return [opt_state]
    return [opt_state["m"], opt_state["v"]]


def from_slot_trees(opt: "Optimizer", trees: Sequence) -> Any:
    if opt.num_slots == 0:
        return None
    if opt.num_slots == 1:
        return trees[0]
    return {"m": trees[0], "v": trees[1]}


def init_slots(opt: "Optimizer", make_tree: Callable[[], Any]) -> Any:
    """Zero state: ``make_tree()`` builds one slot tree, once a slot."""
    return from_slot_trees(opt, [make_tree() for _ in range(opt.num_slots)])


# -- the update rules ---------------------------------------------------------

def _f32c(c: float) -> float:
    """A Python scalar as the float32 value the reference computes with."""
    return float(np.float32(c))


def _norm(x32: torch.Tensor, norm_reduce) -> torch.Tensor:
    return torch.sqrt(norm_reduce(torch.sum(x32 * x32)))


def _ratio(num: torch.Tensor, den: torch.Tensor, scale=None) -> torch.Tensor:
    """``scale·num / max(den, 1e-30)`` where both norms are positive, else
    1 (a fresh zero leaf must still move)."""
    top = num if scale is None else scale * num
    r = top / torch.clamp(den, min=1e-30)
    return torch.where((num > 0.0) & (den > 0.0), r, torch.ones_like(r))


def _sgd_leaf(p: torch.Tensor, g: torch.Tensor, slots: tuple, lr: float,
              t: float, norm_reduce, adapt: bool) -> tuple:
    del slots, t, norm_reduce, adapt
    p.copy_(p.float() - lr * g.float())
    return ()


def _make_momentum_leaf(mu: float) -> UpdateLeaf:
    mu = float(np.float32(mu))  # the reference's weakly typed f32 scalar

    def update(p, g, slots, lr, t, norm_reduce, adapt):
        del t, norm_reduce, adapt
        (b,) = slots
        nb = mu * b.float() + g.float()
        p.copy_(p.float() - lr * nb)
        b.copy_(nb)
        return (b,)
    return update


def _make_lars_leaf(ocfg: OptimConfig) -> UpdateLeaf:
    mu, eta, wd = (_f32c(ocfg.beta1), _f32c(ocfg.trust_coefficient),
                   _f32c(ocfg.weight_decay))

    def update(p, g, slots, lr, t, norm_reduce, adapt):
        del t
        (b,) = slots
        p32, g32 = p.float(), g.float()
        if adapt:
            gw = g32 + wd * p32
            # trust = eta·‖w‖/‖g + wd·w‖; 1 when either norm is 0
            trust = _ratio(_norm(p32, norm_reduce), _norm(gw, norm_reduce),
                           eta)
            gw = trust * gw
        else:
            gw = g32  # biases and norms: no decay, no adaptation
        nb = mu * b.float() + gw
        p.copy_(p32 - lr * nb)
        b.copy_(nb)
        return (b,)
    return update


def _correction(b: float, t: float) -> float:
    """float32 ``1 - b ** t``."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return float(np.float32(1.0)
                 - np.float32(torch.pow(f32(b), f32(t)).item()))


def _lamb_corrections(ocfg: OptimConfig) -> Callable[[float], tuple]:
    b1, b2 = _f32c(ocfg.beta1), _f32c(ocfg.beta2)
    return lambda t: (_correction(b1, t), _correction(b2, t))


def _make_lamb_leaf(ocfg: OptimConfig) -> UpdateLeaf:
    b1, b2 = _f32c(ocfg.beta1), _f32c(ocfg.beta2)
    one_b1, one_b2 = _f32c(1.0 - ocfg.beta1), _f32c(1.0 - ocfg.beta2)
    eps, wd = _f32c(ocfg.eps), _f32c(ocfg.weight_decay)
    corrections = _lamb_corrections(ocfg)

    def update(p, g, slots, lr, t, norm_reduce, adapt):
        m, v = slots
        c1, c2 = t if isinstance(t, tuple) else corrections(t)
        p32, g32 = p.float(), g.float()
        nm = b1 * m.float() + one_b1 * g32
        nv = b2 * v.float() + one_b2 * g32 * g32
        m_hat = nm / c1
        v_hat = nv / c2
        u = m_hat / (torch.sqrt(v_hat) + eps)
        if adapt:
            u = u + wd * p32
            ratio = _ratio(_norm(p32, norm_reduce), _norm(u, norm_reduce))
            p.copy_(p32 - (lr * ratio) * u)
        else:
            p.copy_(p32 - lr * u)
        m.copy_(nm)
        v.copy_(nv)
        return (m, v)
    return update


def make_optimizer(ocfg: OptimConfig) -> Optimizer:
    """Resolve the config into an optimizer (validating it)."""
    kind = opt_state_kind(ocfg)
    if kind == "none":
        return Optimizer(kind="none", num_slots=0, update_leaf=_sgd_leaf)
    if kind == "momentum":
        return Optimizer(kind="momentum", num_slots=1,
                         update_leaf=_make_momentum_leaf(ocfg.momentum))
    if kind == "lars":
        return Optimizer(kind="lars", num_slots=1,
                         update_leaf=_make_lars_leaf(ocfg))
    return Optimizer(kind="lamb", num_slots=2,
                     update_leaf=_make_lamb_leaf(ocfg),
                     corrections=_lamb_corrections(ocfg))

"""Optimizers (≙ ``distributedmnist_tpu/train/optim.py``): ``sgd`` and
``momentum`` as per-leaf update rules.

As in the reference, a leaf's update is computed in float32 and the
new value cast back to the leaf's storage dtype; moment slots are
float32. The slot layout is the reference's: ``None`` for stateless
sgd, else one params-shaped tree. The port updates params and slots
in place (the reference builds new arrays; its buffer donation reuses
the memory just the same). ``lars`` and ``lamb`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.config import ConfigError, OptimConfig

OPTIMIZER_NAMES = ("sgd", "momentum", "lars", "lamb")

# update_leaf(p, g, slots, lr, t, norm_reduce, adapt) -> new slots;
# writes the new p into p. The arguments are the reference's
# (train/optim.py:194-207): ``t`` the 1-based update count (for bias
# corrections), ``norm_reduce`` completing a norm's partial sum over a
# sharded leaf, ``adapt`` whether a trust ratio applies to the leaf —
# sgd and momentum read none of the three; LARS and LAMB will. ``lr`` is
# a Python float holding a float32 value (the schedule's), so
# ``lr * g`` rounds as the reference's float32 product does, and the
# step enqueues no host-to-device copy for it.
UpdateLeaf = Callable[..., tuple]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    kind: str
    num_slots: int
    update_leaf: UpdateLeaf


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


def make_optimizer(ocfg: OptimConfig) -> Optimizer:
    """Resolve the config into an optimizer (validating it)."""
    kind = opt_state_kind(ocfg)
    if kind == "none":
        return Optimizer(kind="none", num_slots=0, update_leaf=_sgd_leaf)
    if kind == "momentum":
        return Optimizer(kind="momentum", num_slots=1,
                         update_leaf=_make_momentum_leaf(ocfg.momentum))
    raise NotImplementedError(f"optimizer {kind!r} is not ported yet (the "
                              "port has sgd and momentum)")

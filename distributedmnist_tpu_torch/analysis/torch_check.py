"""The ``torch`` check (≙ the host-sync rule of ``distributedmnist_tpu/
analysis/jax_check.py``): host syncs in hot loops.

``.item()``, ``.cpu()`` and ``.tolist()`` on a device tensor wait for
the stream to drain and copy to the host. Inside a ``for``/``while``
in a step/batch/loop/run-shaped function (the names the reference's
rule matches) each one turns the loop's asynchronous dispatch into
lockstep with the device, once an iteration. Every such call is a
finding; its key is ``host-sync.<function>.<method>``, the reference's
subject for ``.item()``.

The reference's other two JAX rules have no torch counterpart, so none
is checked here: torch donates no buffer to a call (a tensor stays
valid after any op that reads it), and a captured CUDA graph replays
whatever values its static input tensors hold, where a jitted function
retraces for each new Python scalar. The reference's ``float()`` /
``int()`` rule reads values bound from jitted calls, which the port has
none of.

The AST cannot tell a device tensor from a host one: a ``.tolist()`` of
a numpy array or a ``.cpu()`` of a CPU tensor is a finding too. Those,
and the syncs a loop really needs, are the baseline's to justify.
"""

from __future__ import annotations

import ast
import re

from .core import Finding, Source, make_key, register

_HOT_NAME = re.compile(r"step|batch|loop|run", re.IGNORECASE)
_SYNCS = ("item", "cpu", "tolist")


def _check_host_sync(src: Source, fn: ast.FunctionDef,
                     out: list[Finding], seen: set[int]) -> None:
    if not _HOT_NAME.search(fn.name):
        return
    for loop in ast.walk(fn):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        for node in ast.walk(loop):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNCS) or id(node) in seen:
                continue
            # a call inside nested loops is one finding, not one a loop
            seen.add(id(node))
            out.append(Finding(
                "torch", src.path, node.lineno,
                make_key("torch", src.path,
                         f"host-sync.{fn.name}.{node.func.attr}"),
                f".{node.func.attr}() inside the loop in {fn.name}() "
                "blocks on device completion every iteration — hoist the "
                "fetch to the flush cadence"))


@register("torch")
def check(sources: list[Source]) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        if src.is_test:
            continue
        seen: set[int] = set()
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _check_host_sync(src, node, out, seen)
    return out

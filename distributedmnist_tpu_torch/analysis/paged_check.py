"""The ``paged`` check (≙ ``distributedmnist_tpu/analysis/
paged_check.py``): the dense-materialization lint for the decode hot
path.

The paged KV cache exists so the per-step decode cost scales with the
tokens a sequence ACTUALLY holds, not with ``max_blocks_per_seq``.
Two regressions keep trying to sneak that guarantee away, both
invisible to the type system and to parity tests (the numerics stay
bit-identical — only the cost model breaks):

* **dense gather in a hot function** — calling ``gather_dense`` (the
  host-side test oracle) or ``take_along_axis``-style whole-table
  gathers inside a step/loop/batch/run-shaped function in
  ``servesvc/`` re-materializes ``[slots, max_context]`` K/V every
  iteration.  The paged kernel walks block tables in-kernel; the
  oracle is for tests and the dense *kernel* arm lives in
  ``models/transformer.py``, outside this lint's scope on purpose.
* **per-iteration table rebuild** — constructing the block-table
  array (``zeros``/``asarray``/``array`` over a ``table``-named
  value) inside a loop in a hot function re-uploads the host table
  every step.  The replica caches tables per (version, epoch) and
  re-uploads only when slot composition changes — a rebuild inside
  the loop silently undoes that.

Scope: ``distributedmnist_tpu_torch/servesvc/`` only, tests exempt.  The
expected steady state is ZERO findings — anything this checker emits
is a fresh regression, not baseline material.
"""

from __future__ import annotations

import ast
import re

from .core import (Finding, Source, add_parents, enclosing, make_key,
                   register)

_SCOPE = "distributedmnist_tpu_torch/servesvc/"
_HOT_NAME = re.compile(r"step|batch|loop|run", re.IGNORECASE)
_TABLE_NAME = re.compile(r"table", re.IGNORECASE)
_DENSE_GATHERS = ("gather_dense", "take_along_axis")
_BUILDERS = ("zeros", "asarray", "array", "stack")


def _callee_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _reads_table_name(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and _TABLE_NAME.search(n.id):
            return True
        if isinstance(n, ast.Attribute) and _TABLE_NAME.search(n.attr):
            return True
    return False


def _targets_table_name(call: ast.Call) -> bool:
    """The rebuilt value is table-shaped when the call's result is
    BOUND to a table-named target (``tables = np.zeros(...)``) — the
    arguments are just dims and carry no name signal."""
    stmt = enclosing(call, ast.Assign, ast.AnnAssign, ast.AugAssign)
    if stmt is None:
        return False
    targets = (stmt.targets if isinstance(stmt, ast.Assign)
               else [stmt.target])
    return any(_reads_table_name(t) for t in targets)


def _check_fn(src: Source, fn: ast.FunctionDef,
              out: list[Finding]) -> None:
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _callee_name(node)
        if name in _DENSE_GATHERS:
            out.append(Finding(
                "paged", src.path, node.lineno,
                make_key("paged", src.path,
                         f"dense-gather.{fn.name}.{name}"),
                f"{name}() inside hot function {fn.name}() "
                "re-materializes the dense [slots, max_context] view "
                "every step — the paged kernel walks block tables "
                "in-kernel; the dense gather is a test oracle, not a "
                "serving path"))
        elif (name in _BUILDERS
              and enclosing(node, ast.For, ast.While) is not None
              and (_reads_table_name(node)
                   or _targets_table_name(node))):
            out.append(Finding(
                "paged", src.path, node.lineno,
                make_key("paged", src.path,
                         f"table-rebuild.{fn.name}.{name}"),
                f"block-table {name}() inside a loop in hot function "
                f"{fn.name}() rebuilds + re-uploads the host table "
                "every iteration — cache per (version, epoch) and "
                "re-upload only when slot composition changes"))


@register("paged")
def check(sources: list[Source]) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        if src.is_test:
            continue
        if not src.path.startswith(_SCOPE):
            continue
        add_parents(src.tree)
        for node in ast.walk(src.tree):
            if (isinstance(node, ast.FunctionDef)
                    and _HOT_NAME.search(node.name)):
                _check_fn(src, node, out)
    return out

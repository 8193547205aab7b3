"""The ``net`` check (≙ ``distributedmnist_tpu/analysis/net_check.py``):
the socket-deadline lint.

The serving protocol's robustness story (netchaos partitions, half-open
peers, mid-stream resets) only holds if **every blocking socket
operation on a hot path is bounded**: an unbounded ``recv`` against a
blackholed peer parks a connection thread forever, and an unbounded
``accept`` makes shutdown depend on one more client showing up.  This
pass walks ``servesvc/`` and ``launch/`` (the two packages that own
wire protocol) and flags:

1. ``.recv(...)`` / ``.accept(...)`` / ``.connect(...)`` calls whose
   enclosing **class** (or enclosing function, for module-level code)
   contains no ``settimeout`` call.  Evidence is class-scoped on
   purpose: the listener's ``settimeout`` often lives in ``start()``
   while the ``accept`` loop is a different method of the same object.
2. ``socket.create_connection(...)`` calls that pass no ``timeout``
   (neither the kwarg nor the second positional argument) — the
   default is a *blocking* connect, which a SYN-blackholed endpoint
   turns into a multi-minute kernel stall.

Class-scoped evidence is an over-approximation by design: a timeout
set on socket A does not bound socket B.  But the codebase's idiom is
one socket role per class, and the lint's job is to catch the call
site with *no* deadline discipline anywhere in sight — per-socket
dataflow belongs to review, not AST matching.
"""

from __future__ import annotations

import ast

from .core import Finding, Source, add_parents, enclosing, make_key, register

_BLOCKING_ATTRS = ("recv", "accept", "connect")
_SCOPE_PREFIXES = ("distributedmnist_tpu_torch/servesvc/",
                   "distributedmnist_tpu_torch/launch/")


def _callee_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _scope_of(node: ast.AST, src: Source) -> tuple[ast.AST, str]:
    """The deadline-evidence scope for a call: its class if it has one,
    else its function, else the whole module."""
    cls = enclosing(node, ast.ClassDef)
    if cls is not None:
        return cls, cls.name
    fn = enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)
    if fn is not None:
        return fn, fn.name
    return src.tree, "<module>"


def _has_settimeout(scope: ast.AST) -> bool:
    for node in ast.walk(scope):
        if (isinstance(node, ast.Call)
                and _callee_name(node) == "settimeout"):
            return True
    return False


def _fn_name(node: ast.AST) -> str:
    fn = enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)
    return fn.name if fn is not None else "<module>"


@register("net")
def check(sources: list[Source]) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        if src.is_test:
            continue
        if not src.path.startswith(_SCOPE_PREFIXES):
            continue
        add_parents(src.tree)
        timeout_cache: dict[int, bool] = {}
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _callee_name(node)
            if name == "create_connection":
                # create_connection(addr, timeout) — bounded iff the
                # timeout kwarg or the 2nd positional arg is passed
                if (len(node.args) < 2
                        and not any(kw.arg == "timeout"
                                    for kw in node.keywords)):
                    fn = _fn_name(node)
                    out.append(Finding(
                        "net", src.path, node.lineno,
                        make_key("net", src.path,
                                 f"{fn}.create_connection"),
                        f"create_connection in {fn}() passes no "
                        "timeout — a SYN-blackholed endpoint stalls "
                        "this thread at the kernel's connect "
                        "timeout, minutes past any request "
                        "deadline"))
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _BLOCKING_ATTRS):
                continue
            scope, scope_name = _scope_of(node, src)
            key = id(scope)
            if key not in timeout_cache:
                timeout_cache[key] = _has_settimeout(scope)
            if timeout_cache[key]:
                continue
            fn = _fn_name(node)
            out.append(Finding(
                "net", src.path, node.lineno,
                make_key("net", src.path,
                         f"{scope_name}.{fn}.{node.func.attr}"),
                f"{node.func.attr}() in {scope_name}.{fn} has no "
                "settimeout anywhere in its scope — a half-open or "
                "blackholed peer blocks this call forever and the "
                "thread never rejoins shutdown"))
    return out

"""The ``threads`` check (≙ ``distributedmnist_tpu/analysis/
threads_check.py``): the concurrency lint.

The port runs several long-lived thread kinds (checkpoint follower,
serving batcher/accept/conn threads, async checkpointer worker,
supervisor tick, the chaos proxies, the load generator).  For
every class that spawns threads, this pass:

1. resolves the class's **thread-entry roots** — methods passed as
   ``threading.Thread(target=...)`` (directly, via a loop over a tuple
   of bound methods, or via a local alias) — plus the synthetic
   ``caller`` root (public methods invoked from whatever thread owns
   the object);
2. builds the intra-class call graph and computes which roots can
   reach each method;
3. flags instance attributes assigned (outside ``__init__`` —
   construction happens-before thread start) from **more than one
   root** where at least one write is not under a ``with self.<lock>``
   guard (lock attributes are recognized by construction —
   ``threading.Lock/RLock/Condition/Semaphore`` — or by name).

This is a reachability over-approximation by design: a write two
threads CAN reach without a lock is a hazard even if today's
interleavings dodge it.  Guards taken by the caller one frame up are
invisible to the AST — those are exactly what the baseline file's
one-line justifications are for.
"""

from __future__ import annotations

import ast

from .core import (Finding, Source, add_parents, enclosing, make_key,
                   register)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_LOCKISH = ("lock", "cond", "mutex", "wake", "cv")


def _callee_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _self_attr(node: ast.expr, self_name: str = "self") -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == self_name):
        return node.attr
    return None


def _thread_targets(cls: ast.ClassDef,
                    method_names: set[str]) -> set[str]:
    """Methods of this class used as Thread targets."""
    roots: set[str] = set()
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Call)
                and _callee_name(node) in ("Thread", "Timer")):
            continue
        # Thread(group, target, ...) / Timer(interval, function, ...):
        # the callable is the `target`/`function` kwarg, or positional
        # index 1 — arg0 is group/interval, never the callable
        target_expr = None
        for kw in node.keywords:
            if kw.arg in ("target", "function"):
                target_expr = kw.value
        if target_expr is None and len(node.args) > 1:
            target_expr = node.args[1]
        if target_expr is None:
            continue
        m = _self_attr(target_expr)
        if m in method_names:
            roots.add(m)
            continue
        if isinstance(target_expr, ast.Name):
            # resolve a local alias: `t = self._m` assignments and
            # `for target in (self._a, self._b): Thread(target=target)`
            fn = enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)
            if fn is None:
                continue
            var = target_expr.id
            for stmt in ast.walk(fn):
                if (isinstance(stmt, ast.Assign)
                        and any(isinstance(t, ast.Name) and t.id == var
                                for t in stmt.targets)):
                    m = _self_attr(stmt.value)
                    if m in method_names:
                        roots.add(m)
                elif (isinstance(stmt, ast.For)
                      and isinstance(stmt.target, ast.Name)
                      and stmt.target.id == var
                      and isinstance(stmt.iter, (ast.Tuple, ast.List))):
                    for el in stmt.iter.elts:
                        m = _self_attr(el)
                        if m in method_names:
                            roots.add(m)
    return roots


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Call):
            if _callee_name(node.value) in _LOCK_CTORS:
                for t in node.targets:
                    a = _self_attr(t)
                    if a:
                        out.add(a)
    return out


def _guarded(node: ast.AST, lock_attrs: set[str]) -> bool:
    """Is this statement lexically inside ``with self.<lock>:``?"""
    cur = getattr(node, "parent", None)
    while cur is not None and not isinstance(cur, (ast.FunctionDef,
                                                   ast.AsyncFunctionDef)):
        if isinstance(cur, ast.With):
            for item in cur.items:
                ctx = item.context_expr
                a = _self_attr(ctx)
                if a is None and isinstance(ctx, ast.Attribute):
                    a = ctx.attr
                if a and (a in lock_attrs
                          or any(s in a.lower() for s in _LOCKISH)):
                    return True
        cur = getattr(cur, "parent", None)
    return False


def _reach(edges: dict[str, set[str]], entries: set[str]) -> set[str]:
    seen = set(entries)
    work = list(entries)
    while work:
        m = work.pop()
        for n in edges.get(m, ()):
            if n not in seen:
                seen.add(n)
                work.append(n)
    return seen


def _check_class(src: Source, cls: ast.ClassDef,
                 out: list[Finding]) -> None:
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    thread_roots = _thread_targets(cls, set(methods))
    if not thread_roots:
        return
    lock_attrs = _lock_attrs(cls)

    edges: dict[str, set[str]] = {}
    for name, fn in methods.items():
        outs: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                m = _self_attr(node.func)
                if m in methods:
                    outs.add(m)
        edges[name] = outs

    reach = {t: _reach(edges, {t}) for t in thread_roots}
    caller_entries = {n for n in methods
                      if not n.startswith("_") and n not in thread_roots}
    reach["caller"] = _reach(edges, caller_entries)

    # attr -> {root}, plus the unguarded evidence
    attr_roots: dict[str, set[str]] = {}
    attr_unguarded: dict[str, tuple[int, str]] = {}
    for name, fn in methods.items():
        if name == "__init__":
            continue  # construction happens-before thread start
        roots = {t for t in thread_roots if name in reach[t]}
        if name in reach["caller"]:
            roots.add("caller")
        if not roots:
            continue
        for node in ast.walk(fn):
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                attr = _self_attr(t)
                if attr is None or attr in lock_attrs:
                    continue
                attr_roots.setdefault(attr, set()).update(roots)
                if (attr not in attr_unguarded
                        and not _guarded(node, lock_attrs)):
                    attr_unguarded[attr] = (node.lineno, name)

    for attr, roots in sorted(attr_roots.items()):
        if len(roots) < 2 or attr not in attr_unguarded:
            continue
        line, method = attr_unguarded[attr]
        out.append(Finding(
            "threads", src.path, line,
            make_key("threads", src.path, f"{cls.name}.{attr}"),
            f"{cls.name}.{attr} is written from "
            f"{len(roots)} thread-entry roots "
            f"({', '.join(sorted(roots))}) and the write in "
            f"{method}() holds no lock — unsynchronized cross-thread "
            "mutation"))


@register("threads")
def check(sources: list[Source]) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        if src.is_test:
            continue
        add_parents(src.tree)
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                _check_class(src, node, out)
    return out

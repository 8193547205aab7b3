"""The checks' plumbing (≙ ``distributedmnist_tpu/analysis/core.py``):
findings, source walking, baseline handling.

Checker modules register themselves in :data:`CHECKERS`; each exposes
``check(sources) -> list[Finding]`` over the parsed source set.  A
finding's ``key`` is deliberately line-number-free so the checked-in
baseline survives unrelated edits to the same file.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Any, Callable, Iterable


@dataclasses.dataclass
class Source:
    """One parsed module: repo-relative path + AST + raw text."""

    path: str            # repo-relative, forward slashes
    tree: ast.Module
    text: str
    # set when the file did not parse: the tree is an empty sentinel
    # and run_checkers reports the error as a finding — an unparseable
    # file must never read as a clean one
    parse_error: str | None = None

    @property
    def is_test(self) -> bool:
        return self.path.startswith("tests/")


@dataclasses.dataclass(frozen=True)
class Finding:
    checker: str         # schema | config | threads | torch | ...
    path: str            # repo-relative file
    line: int            # 1-indexed (display only; not part of the key)
    key: str             # stable identity: checker:path:subject
    message: str

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def make_key(checker: str, path: str, subject: str) -> str:
    return f"{checker}:{path}:{subject}"


# ---------------------------------------------------------------------------
# source loading
# ---------------------------------------------------------------------------

def iter_sources(roots: Iterable[str | Path],
                 repo_root: str | Path | None = None) -> list[Source]:
    """Parse every ``*.py`` under ``roots`` (files or directories).
    Paths in findings are relative to ``repo_root`` (default: the
    repository checkout containing this package)."""
    if repo_root is None:
        repo_root = Path(__file__).resolve().parents[2]
    repo_root = Path(repo_root).resolve()
    out: list[Source] = []
    for root in roots:
        root = Path(root).resolve()
        files = [root] if root.is_file() else sorted(root.rglob("*.py"))
        for f in files:
            try:
                rel = f.relative_to(repo_root).as_posix()
            except ValueError:
                rel = f.as_posix()
            text = f.read_text()
            err: str | None = None
            try:
                tree = ast.parse(text, filename=str(f))
            except SyntaxError as e:
                tree = ast.Module(body=[], type_ignores=[])
                err = f"{e.msg} (line {e.lineno})"
            out.append(Source(path=rel, tree=tree, text=text,
                              parse_error=err))
    return out


def add_parents(tree: ast.AST) -> None:
    """Annotate every node with ``.parent`` (checkers walk upward for
    lock guards / enclosing loops)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def enclosing(node: ast.AST, *types: type) -> ast.AST | None:
    """Nearest ancestor of one of ``types`` (requires add_parents)."""
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, types):
            return cur
        cur = getattr(cur, "parent", None)
    return None


# ---------------------------------------------------------------------------
# baseline (accepted findings, each with a justification)
# ---------------------------------------------------------------------------

def load_baseline(path: str | Path | None = None) -> dict[str, str]:
    """{finding key: justification}.  The default baseline ships with
    the package (``analysis/baseline.json``)."""
    if path is None:
        path = Path(__file__).with_name("baseline.json")
    path = Path(path)
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    out: dict[str, str] = {}
    for entry in data.get("accepted", []):
        out[entry["key"]] = entry.get("justification", "")
    return out


def baseline_to_json(findings: list[Finding],
                     justification: str = "TODO: justify") -> str:
    """Serialize current findings as a baseline skeleton (the
    ``--write-baseline`` helper output)."""
    return json.dumps(
        {"accepted": [{"key": f.key, "justification": justification,
                       "message": f.message}
                      for f in sorted(findings, key=lambda f: f.key)]},
        indent=2) + "\n"


# ---------------------------------------------------------------------------
# checker registry
# ---------------------------------------------------------------------------

CHECKERS: dict[str, Callable[[list[Source]], list[Finding]]] = {}


def register(name: str):
    def deco(fn):
        CHECKERS[name] = fn
        return fn
    return deco


def run_checkers(sources: list[Source],
                 names: Iterable[str] | None = None) -> list[Finding]:
    # import for side effect: each checker module registers itself
    from . import (config_check, durability_check,  # noqa: F401
                   net_check, paged_check, schema_check, threads_check,
                   torch_check)
    findings: list[Finding] = []
    # an unparseable file yields an empty AST — every checker would
    # silently report it clean (and its dropped reads could even fake
    # dead-knob findings elsewhere), so the parse failure IS a finding
    for src in sources:
        if src.parse_error is not None:
            findings.append(Finding(
                "parse", src.path, 1,
                make_key("parse", src.path, "syntax-error"),
                f"file does not parse ({src.parse_error}) — no checker "
                "can see into it"))
    for name, fn in sorted(CHECKERS.items()):
        if names is not None and name not in names:
            continue
        findings += fn(sources)
    return sorted(findings, key=lambda f: (f.path, f.line, f.key))

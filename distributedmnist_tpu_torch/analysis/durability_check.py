"""The ``durability`` check (≙ ``distributedmnist_tpu/analysis/
durability_check.py``): the write-path provenance lint.

The crash-consistency story (``tests/test_torch_crash_consistency.py``,
the storage invariant) is only as strong as its coverage: the storage shim
(train/storage.py) is where fsync policy is applied, disk faults are
injected, and torn/ENOSPC degradation is journaled — so a durable
artifact written around the shim is an artifact the chaos campaign
can never fault and the durability knob can never fsync. This pass
flags raw write APIs that bypass it:

1. In the packages that OWN durable training artifacts (``train/``,
   ``quant/``), every raw ``open(.., "w"/"a"/"x")``, ``Path.
   write_bytes`` / ``write_text``, and ``os.replace`` / ``os.rename``
   outside the shim itself is a finding — there is no legitimate
   direct write there; checkpoints, manifests, digest sidecars, and
   pointers all route through ``storage.write_bytes`` /
   ``write_text`` / ``replace``.
2. Everywhere else, the same raw calls are findings only when the
   path expression textually names a durable artifact (``ckpt``,
   ``checkpoint``, ``manifest``, a digest/journal suffix) — a
   supervisor writing ``results.json`` is fine; a supervisor writing
   ``checkpoint.json`` behind the shim's back is the lint's point.

Textual path evidence is an under-approximation by design: a write to
an alias the AST cannot name slips through. The lint's job is the
honest-mistake case — a new call site pasted from pre-shim code — not
adversarial dataflow; that belongs to review.

Journal APPENDS are deliberately out of scope: ``core/log.py``'s
JsonlSink is the one append path and already routes its fsync
decision through ``storage.journal_sync_enabled()``.
"""

from __future__ import annotations

import ast

from .core import Finding, Source, add_parents, enclosing, make_key, register

# the shim itself — the one module allowed to touch raw write APIs
_SHIM = "distributedmnist_tpu_torch/train/storage.py"
# packages where EVERY raw write is a bypass, path spelling aside
_STRICT_PREFIXES = ("distributedmnist_tpu_torch/train/",
                    "distributedmnist_tpu_torch/quant/")
# spellings that mark a path expression as a durable artifact
_DURABLE_MARKERS = ("ckpt", "checkpoint", "manifest", "sha256",
                    "msgpack", "sidecar", "recovery_journal",
                    "storage_faults")


def _callee(call: ast.Call) -> tuple[str | None, str | None]:
    """(receiver module/name, attribute) for ``x.y(...)``; (None, name)
    for a bare ``name(...)`` call."""
    f = call.func
    if isinstance(f, ast.Name):
        return None, f.id
    if isinstance(f, ast.Attribute):
        base = f.value
        return (base.id if isinstance(base, ast.Name) else None), f.attr
    return None, None


def _open_mode(call: ast.Call) -> str | None:
    """The literal mode string of an ``open`` call, '' when defaulted
    (→ read), None when non-literal (undecidable — skip)."""
    mode: ast.AST | None = call.args[1] if len(call.args) > 1 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return ""
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


def _path_expr(call: ast.Call) -> str:
    """Unparsed source of the call's path operand — the first argument
    for ``open``/``os.replace``, the receiver for Path methods."""
    if isinstance(call.func, ast.Attribute) and call.func.attr in (
            "write_bytes", "write_text"):
        return ast.unparse(call.func.value)
    return ast.unparse(call.args[0]) if call.args else ""


def _fn_name(node: ast.AST) -> str:
    fn = enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)
    return fn.name if fn is not None else "<module>"


@register("durability")
def check(sources: list[Source]) -> list[Finding]:
    out: list[Finding] = []
    for src in sources:
        if src.is_test or src.path == _SHIM:
            continue
        if not src.path.startswith("distributedmnist_tpu_torch/"):
            continue
        add_parents(src.tree)
        strict = src.path.startswith(_STRICT_PREFIXES)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            base, name = _callee(node)
            if name == "open" and base is None:
                mode = _open_mode(node)
                if mode is None or not any(c in mode for c in "wax"):
                    continue
                what = f'open(mode="{mode}")'
            elif name in ("write_bytes", "write_text") and isinstance(
                    node.func, ast.Attribute):
                if base == "storage":
                    continue  # the shim's own API — the routed path
                what = f"{name}()"
            elif base == "os" and name in ("replace", "rename"):
                what = f"os.{name}()"
            else:
                continue
            path_src = _path_expr(node)
            lowered = path_src.lower()
            if not strict and not any(m in lowered
                                      for m in _DURABLE_MARKERS):
                continue
            fn = _fn_name(node)
            out.append(Finding(
                "durability", src.path, node.lineno,
                make_key("durability", src.path, f"{fn}.{what}"),
                f"{what} on {path_src or '<unknown path>'} in {fn}() "
                "bypasses the storage shim (train/storage.py) — this "
                "write gets no fsync policy, no fault injection, and "
                "no torn/ENOSPC degradation journaling; route it "
                "through storage.write_bytes/write_text/replace"))
    return out

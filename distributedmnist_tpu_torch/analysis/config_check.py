"""The ``config`` check (≙ ``distributedmnist_tpu/analysis/
config_check.py``): the config-knob audit.

The declared surface is parsed from ``core/config.py``'s AST (never
imported): every ``@dataclass`` section class's fields and methods,
and the ``ExperimentConfig`` section map.  Two directions:

* **undeclared access** — any ``<cfg>.<section>.<field>`` attribute
  chain in the package or tests, where ``<cfg>`` is a config-named
  base (``cfg``, ``config``, ``self.cfg``, ``base_config()``, …) and
  ``<section>`` is a declared section, must name a declared field or
  method of that section class.  A typo'd knob read returns
  AttributeError at runtime only on the code path that reaches it —
  here it fails CI.
* **dead knob** — a declared field never read anywhere (not as an
  attribute of anything, not as a keyword argument, not as a string
  key in any dict/config literal) is flagged: config surface nobody
  consumes is a lie to operators.
"""

from __future__ import annotations

import ast

from .core import Finding, Source, make_key, register

_CONFIG_PATH = "distributedmnist_tpu_torch/core/config.py"

# names every dataclass instance answers without declaring
_ALWAYS_OK = {"replace",}


def _is_dataclass_def(node: ast.ClassDef) -> bool:
    for d in node.decorator_list:
        target = d.func if isinstance(d, ast.Call) else d
        name = (target.id if isinstance(target, ast.Name)
                else target.attr if isinstance(target, ast.Attribute)
                else None)
        if name == "dataclass":
            return True
    return False


def parse_declared(config_src: Source) -> tuple[dict[str, str],
                                                dict[str, set[str]],
                                                dict[str, set[str]],
                                                dict[str, int]]:
    """(section -> class name, class -> fields, class -> methods,
    ``section.field`` -> declaration line)."""
    fields: dict[str, set[str]] = {}
    methods: dict[str, set[str]] = {}
    lines: dict[str, dict[str, int]] = {}
    classes: dict[str, ast.ClassDef] = {}
    for node in config_src.tree.body:
        if isinstance(node, ast.ClassDef) and _is_dataclass_def(node):
            classes[node.name] = node
            fields[node.name] = set()
            methods[node.name] = set()
            lines[node.name] = {}
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)):
                    fields[node.name].add(stmt.target.id)
                    lines[node.name][stmt.target.id] = stmt.lineno
                elif isinstance(stmt, ast.FunctionDef):
                    methods[node.name].add(stmt.name)
    sections: dict[str, str] = {}
    decl_lines: dict[str, int] = {}
    exp = classes.get("ExperimentConfig")
    if exp is not None:
        for stmt in exp.body:
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                ann = stmt.annotation
                cls = (ann.id if isinstance(ann, ast.Name)
                       else ann.value if isinstance(ann, ast.Constant)
                       else None)
                if isinstance(cls, str) and cls in classes:
                    sections[stmt.target.id] = cls
    for sec, cls in sections.items():
        for f, ln in lines[cls].items():
            decl_lines[f"{sec}.{f}"] = ln
    return sections, fields, methods, decl_lines


def _config_base(node: ast.expr) -> bool:
    """Is this expression plausibly an ExperimentConfig value?"""
    if isinstance(node, ast.Name):
        n = node.id.lower()
        return n in ("cfg", "config") or n.endswith("cfg") \
            or n.endswith("config")
    if isinstance(node, ast.Attribute):
        n = node.attr.lower()
        return n in ("cfg", "_cfg", "config") or n.endswith("cfg")
    if isinstance(node, ast.Call):
        f = node.func
        n = (f.id if isinstance(f, ast.Name)
             else f.attr if isinstance(f, ast.Attribute) else "")
        return "config" in n.lower() or n.lower().endswith("cfg")
    return False


@register("config")
def check(sources: list[Source]) -> list[Finding]:
    config_src = next((s for s in sources if s.path == _CONFIG_PATH),
                      None)
    if config_src is None:
        return []
    sections, fields, methods, decl_lines = parse_declared(config_src)

    out: list[Finding] = []
    # everything that counts as "this name is consumed somewhere"
    read_names: set[str] = set()

    for src in sources:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Attribute):
                read_names.add(node.attr)
                # strict <cfg>.<section>.<field> resolution
                v = node.value
                if (isinstance(v, ast.Attribute)
                        and v.attr in sections
                        and _config_base(v.value)):
                    cls = sections[v.attr]
                    field = node.attr
                    if field.startswith("__"):
                        continue
                    if (field not in fields[cls]
                            and field not in methods[cls]
                            and field not in _ALWAYS_OK):
                        out.append(Finding(
                            "config", src.path, node.lineno,
                            make_key("config", src.path,
                                     f"unknown.{v.attr}.{field}"),
                            f"cfg.{v.attr}.{field} does not resolve to "
                            f"a declared field of {cls} "
                            "(core/config.py) — typo'd or removed "
                            "knob"))
            elif isinstance(node, ast.keyword) and node.arg:
                read_names.add(node.arg)
            elif (isinstance(node, ast.Constant)
                  and isinstance(node.value, str)
                  and len(node.value) < 200):
                # dict keys in config literals, dotted CLI overrides,
                # f-string fragments — split on the delimiters knobs
                # travel through
                for part in node.value.replace("=", ".").split("."):
                    part = part.strip()
                    if part.isidentifier():
                        read_names.add(part)

    # dead knobs: declared but consumed nowhere outside config.py's own
    # declarations.  config.py itself contributes reads too (validate()
    # bodies, effective_* helpers) — those count.
    for section, cls in sorted(sections.items()):
        for field in sorted(fields[cls]):
            if field not in read_names:
                out.append(Finding(
                    "config", _CONFIG_PATH,
                    decl_lines.get(f"{section}.{field}", 1),
                    make_key("config", _CONFIG_PATH,
                             f"dead.{section}.{field}"),
                    f"declared knob {section}.{field} is never read "
                    "anywhere in the package or tests — dead config "
                    "surface"))
    return out

"""The ``schema`` check (≙ ``distributedmnist_tpu/analysis/
schema_check.py``): journal emit sites vs the event registry.

Resolves every emit site whose payload is a LITERAL dict — full
records carrying ``"event"`` (``exec.journal``, ``JsonlSink.write``,
the chaos/eval/loadgen writers), and the wrapper helpers that add the
kind downstream (``ServingReplica._journal``/``_terminal`` → serve,
``Trainer._recovery_event`` / checkpoint ``on_event`` callbacks →
recovery, ``ClusterSupervisor._event``/``_reconf_event`` →
recovery/reconfigure) — and verifies the payload against
``obsv/schema.py``: the kind is declared, the action is declared,
every required field is present, no undeclared field is written.

Payloads the AST can't see (``**fields`` expansions, dicts built in
loops) get the literal keys they DO show checked, and the rest is the
runtime validator's job (``schema.maybe_check_event``, on in tests).

Test files are exempt: their event-dict literals are overwhelmingly
READER fixtures (deliberately legacy/torn records proving the readers
tolerate them); writes tests perform through the shared sinks are
runtime-validated instead.

The registry is the port's own ``obsv/schema.py``, loaded by file path
(``importlib`` on that file alone — it is pure stdlib), so the checker
never imports the analyzed package, nor the reference's registry.
"""

from __future__ import annotations

import ast
import importlib.util
import sys
from pathlib import Path

from .core import Finding, Source, make_key, register

# wrapper-call table: helper name -> (event kind, mode, path prefixes)
#   mode "payload":    sole positional arg is the payload dict
#   mode "action-arg": arg0 is the action literal, keywords the payload
# implicit: fields the wrapper adds before the record hits the sink
_WRAPPERS: dict[str, tuple[str, str, tuple[str, ...], frozenset[str]]] = {
    "_journal": ("serve", "payload", ("distributedmnist_tpu_torch/servesvc/",),
                 frozenset({"event", "time"})),
    "_terminal": ("serve", "action-arg",
                  ("distributedmnist_tpu_torch/servesvc/",),
                  frozenset({"event", "time", "action", "id"})),
    "_recovery_event": ("recovery", "payload",
                        ("distributedmnist_tpu_torch/train/",),
                        frozenset({"event", "time"})),
    "_event": ("recovery", "action-arg",
               ("distributedmnist_tpu_torch/launch/supervisor",),
               frozenset({"event", "layer", "action", "time", "seed"})),
    "_reconf_event": ("reconfigure", "action-arg",
                      ("distributedmnist_tpu_torch/launch/supervisor",),
                      frozenset({"event", "layer", "action", "time",
                                 "seed"})),
    "_autoscale_event": ("autoscale", "action-arg",
                         ("distributedmnist_tpu_torch/launch/broker",),
                         frozenset({"event", "layer", "action", "time",
                                    "seed"})),
    # checkpoint-layer callbacks: the Trainer re-journals these as
    # event:"recovery" records (train/loop.py _recovery_event)
    "on_event": ("recovery", "payload", ("distributedmnist_tpu_torch/",),
                 frozenset({"event", "time"})),
    "_on_event": ("recovery", "payload", ("distributedmnist_tpu_torch/",),
                  frozenset({"event", "time"})),
}


def load_registry():
    """The port's ``obsv/schema.py`` registry, loaded standalone (no
    package import)."""
    path = Path(__file__).resolve().parents[1] / "obsv" / "schema.py"
    spec = importlib.util.spec_from_file_location("_dmt_torch_schema",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    # dataclasses resolves string annotations via sys.modules — the
    # standalone module must be registered before exec
    sys.modules["_dmt_torch_schema"] = mod
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return mod


def _dict_literal_keys(node: ast.Dict) -> tuple[dict[str, ast.expr], bool]:
    """(literal string keys -> value node, has_dynamic_part)."""
    keys: dict[str, ast.expr] = {}
    dynamic = False
    for k, v in zip(node.keys, node.values):
        if k is None:  # **expansion
            dynamic = True
        elif isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys[k.value] = v
        else:
            dynamic = True
    return keys, dynamic


def _check_payload(reg, src: Source, line: int, kind: str,
                   action: str | None, action_dynamic: bool,
                   keys: set[str], payload_dynamic: bool,
                   implicit: frozenset[str],
                   out: list[Finding]) -> None:
    envelope = set(reg.ENVELOPE_FIELDS) | implicit
    sch = reg.schema_for(kind)
    if sch is None:
        out.append(Finding(
            "schema", src.path, line,
            make_key("schema", src.path, f"unknown-kind.{kind}"),
            f'emit of undeclared journal event kind "{kind}" — declare '
            "it in obsv/schema.py"))
        return
    allowed = set(sch.required) | set(sch.optional) | envelope
    required = [f for f in sch.required
                if f != "action" or "action" not in implicit]
    act = None
    if sch.actions is not None:
        if action is not None:
            act = sch.actions.get(action)
            if act is None:
                out.append(Finding(
                    "schema", src.path, line,
                    make_key("schema", src.path,
                             f"unknown-action.{kind}.{action}"),
                    f'emit of event "{kind}" with undeclared action '
                    f'"{action}" — declare it in obsv/schema.py'))
                return
            allowed |= set(act.required) | set(act.optional)
            required = required + list(act.required)
        elif action_dynamic or "action" in keys:
            # action resolved at runtime: any declared action's fields
            # are plausible — only literal-key sanity applies
            for a in sch.actions.values():
                allowed |= set(a.required) | set(a.optional)
            required = []
        else:
            # kind has an action axis but this emit names none
            required = list(sch.required)
    if not payload_dynamic:
        subj = f"{kind}.{action}" if action else kind
        for f in required:
            if f not in keys and f not in envelope:
                out.append(Finding(
                    "schema", src.path, line,
                    make_key("schema", src.path, f"missing.{subj}.{f}"),
                    f'emit of event "{kind}"'
                    + (f' action "{action}"' if action else "")
                    + f' omits required field "{f}" '
                    "(obsv/schema.py) — a reader projecting this field "
                    "gets None"))
    if not sch.open_payload:
        subj = f"{kind}.{action}" if action else kind
        for f in sorted(keys - allowed - {"event", "action"}):
            out.append(Finding(
                "schema", src.path, line,
                make_key("schema", src.path, f"undeclared.{subj}.{f}"),
                f'emit of event "{kind}"'
                + (f' action "{action}"' if action else "")
                + f' writes undeclared field "{f}" — add it to '
                "obsv/schema.py or stop writing it"))


def _scan_module(reg, src: Source, out: list[Finding]) -> None:
    handled_dicts: set[int] = set()

    # pass 1: wrapper helper calls
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        name = None
        if isinstance(node.func, ast.Attribute):
            name = node.func.attr
        elif isinstance(node.func, ast.Name):
            name = node.func.id
        spec = _WRAPPERS.get(name or "")
        if spec is None:
            continue
        kind, mode, prefixes, implicit = spec
        if not any(src.path.startswith(p) for p in prefixes):
            continue
        if mode == "payload":
            if len(node.args) != 1 or not isinstance(node.args[0],
                                                     ast.Dict):
                continue
            payload = node.args[0]
            keys, dynamic = _dict_literal_keys(payload)
            if "event" in keys:
                continue  # a full record: pass 2 owns it
            handled_dicts.add(id(payload))
            action_node = keys.get("action")
            action = (action_node.value
                      if isinstance(action_node, ast.Constant)
                      and isinstance(action_node.value, str) else None)
            _check_payload(reg, src, node.lineno, kind, action,
                           action_dynamic="action" in keys
                           and action is None,
                           keys=set(keys), payload_dynamic=dynamic,
                           implicit=implicit, out=out)
        else:  # action-arg
            if not node.args:
                continue
            a0 = node.args[0]
            action = (a0.value if isinstance(a0, ast.Constant)
                      and isinstance(a0.value, str) else None)
            keys = {kw.arg for kw in node.keywords if kw.arg is not None}
            dynamic = any(kw.arg is None for kw in node.keywords)
            _check_payload(reg, src, node.lineno, kind, action,
                           action_dynamic=action is None,
                           keys=keys, payload_dynamic=dynamic,
                           implicit=implicit, out=out)

    # pass 2: any literal dict that IS a full journal record
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Dict) or id(node) in handled_dicts:
            continue
        keys, dynamic = _dict_literal_keys(node)
        ev = keys.get("event")
        if not (isinstance(ev, ast.Constant) and isinstance(ev.value,
                                                            str)):
            continue
        action_node = keys.get("action")
        action = (action_node.value
                  if isinstance(action_node, ast.Constant)
                  and isinstance(action_node.value, str) else None)
        _check_payload(reg, src, node.lineno, ev.value, action,
                       action_dynamic="action" in keys and action is
                       None,
                       keys=set(keys) - {"event"},
                       payload_dynamic=dynamic,
                       implicit=frozenset(), out=out)


@register("schema")
def check(sources: list[Source]) -> list[Finding]:
    reg = load_registry()
    out: list[Finding] = []
    for src in sources:
        if src.is_test:
            continue
        if src.path.endswith("obsv/schema.py"):
            continue  # the registry's own docs/examples
        _scan_module(reg, src, out)
    return out

"""The port's static checks (``distributedmnist_tpu_torch/analysis/``)
against the reference's (``distributedmnist_tpu/analysis/``).

* The six shared checkers (``schema``, ``config``, ``threads``,
  ``durability``, ``net``, ``paged``): the reference's own fixture
  snippets (``tests/test_analysis.py``), placed at the mirrored port
  path, give the same findings through both packages — checker, line,
  message, and key with the package prefix mapped. Each package's
  ``config`` check reads its own ``core/config.py``, and its ``schema``
  check its own registry; the snippets use kinds and fields both
  registries declare.
* The ``torch`` check (≙ the host-sync rule of the reference's ``jax``
  check): ``.item()``, ``.cpu()`` and ``.tolist()`` in a loop of a
  step/batch/loop/run-shaped function; on the reference's ``.item()``
  snippet it gives the reference's line and subject. The donation and
  scalar-signature rules are not carried over.
* The gate: ``python -m distributedmnist_tpu_torch.analysis`` exits 0
  over the port with its own baseline (every entry justified, none
  stale), 1 on a new finding, 2 on a stale entry; an unknown checker is
  a usage error. No checker module imports the analyzed code, ``jax``,
  ``torch`` or anything of ``distributedmnist_tpu``.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from distributedmnist_tpu.analysis import config_check as ref_config
from distributedmnist_tpu.analysis import durability_check as ref_durability
from distributedmnist_tpu.analysis import jax_check as ref_jax
from distributedmnist_tpu.analysis import net_check as ref_net
from distributedmnist_tpu.analysis import paged_check as ref_paged
from distributedmnist_tpu.analysis import schema_check as ref_schema
from distributedmnist_tpu.analysis import threads_check as ref_threads
from distributedmnist_tpu.analysis.core import Source as RefSource
from distributedmnist_tpu_torch.analysis import (CHECKERS, iter_sources,
                                                 load_baseline, run_checkers)
from distributedmnist_tpu_torch.analysis import (config_check,
                                                 durability_check, net_check,
                                                 paged_check, schema_check,
                                                 threads_check, torch_check)
from distributedmnist_tpu_torch.analysis.__main__ import (default_roots,
                                                          main as cli_main)
from distributedmnist_tpu_torch.analysis.core import Source

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "distributedmnist_tpu_torch"
REF, MINE = "distributedmnist_tpu/", "distributedmnist_tpu_torch/"

CHECKS = {"schema": (ref_schema, schema_check),
          "config": (ref_config, config_check),
          "threads": (ref_threads, threads_check),
          "durability": (ref_durability, durability_check),
          "net": (ref_net, net_check),
          "paged": (ref_paged, paged_check)}

_RACY = """
import threading

class Racy:
    def __init__(self):
        self.counter = 0
        self._lock = threading.Lock()
        self.t = threading.Thread(target=self._work)

    def _work(self):
        while True:
            self.counter += 1

    def bump(self):
        self.counter += 1
"""

_LOCKED = _RACY.replace(
    "    def bump(self):\n        self.counter += 1\n",
    "    def bump(self):\n        with self._lock:\n"
    "            self.counter += 1\n").replace(
    "        while True:\n            self.counter += 1\n",
    "        while True:\n            with self._lock:\n"
    "                self.counter += 1\n")

_INIT_ONLY = _RACY.replace(
    "    def bump(self):\n        self.counter += 1\n", "").replace(
    "        while True:\n            self.counter += 1\n",
    "        while True:\n            pass\n")


def _spawned(spawn: str) -> str:
    return f"""
import threading

class Racy:
    def __init__(self):
        self.counter = 0

    def start(self):
        {spawn}

    def _work(self):
        self.counter += 1

    def bump(self):
        self.counter += 1
"""


_LOOPER = """
import threading

class Looper:
    def __init__(self):
        self.state = 0

    def start(self):
        for target in (self._a, self._b):
            threading.Thread(target=target).start()

    def _a(self):
        self.state = 1

    def _b(self):
        self.state = 2
"""

L, T, S = (REF + "launch/snippet.py", REF + "train/snippet.py",
           REF + "servesvc/snippet.py")

# id -> (checker, reference path, snippet): tests/test_analysis.py's
# fixtures, bad and good twins alike
CASES = {
    "schema-unknown-kind": ("schema", L,
                            'sink.write({"event": "telemetry", "x": 1})\n'),
    "schema-missing-field": ("schema", L,
                             'sink.write({"event": "save", '
                             '"save_stall_ms": 1.0,\n'
                             '            "async_snapshot": True})\n'),
    "schema-undeclared-field": ("schema", L,
                                'sink.write({"event": "save", "at_step": 3, '
                                '"step": 3,\n            "save_stall_ms": '
                                '1.0, "async_snapshot": True})\n'),
    "schema-undeclared-action": ("schema", L,
                                 'j({"event": "recovery", "action": '
                                 '"resurrect", "worker": 1})\n'),
    "schema-conforming": ("schema", L,
                          'sink.write({"event": "save", "at_step": 3, '
                          '"time": 1.0,\n            "save_stall_ms": 1.0, '
                          '"async_snapshot": True})\n'),
    "schema-dynamic": ("schema", L, 'sink.write({"event": "save", '
                                    '"bogus": 1, **extra})\n'),
    "schema-wrapper-kwargs": ("schema", REF + "launch/supervisor.py",
                              'self._event("detect", worker=1, '
                              'kindz="dead")\n'),
    "schema-serve-wrapper": ("schema", REF + "servesvc/server.py",
                             'self._terminal("reject", rid, reasonz=1)\n'),
    "schema-tests-exempt": ("schema", "tests/test_x.py",
                            'w({"event": "telemetry", "x": 1})\n'),
    "config-unknown-knob": ("config", T, "def f(cfg):\n"
                                         "    return cfg.train.max_stepz\n"),
    "config-declared-and-methods": (
        "config", T, "def f(cfg):\n"
                     "    a = cfg.train.max_steps\n"
                     "    b = cfg.quant.resolved_publish_tiers()\n"
                     "    c = cfg.data.effective_device_prefetch_depth()\n"),
    "config-serve-typo": ("config", S, "def f(cfg):\n"
                                       "    return cfg.serve.tp_rankz\n"),
    "paged-dense-gather": ("paged", S,
                           "def _step_active(self):\n"
                           "    ks, vs = self.cache.gather_dense(table, "
                           "length)\n"),
    "paged-table-rebuild": ("paged", S,
                            "def _step_active(self):\n"
                            "    for s in self._slots:\n"
                            "        tables = np.zeros((n, width))\n"),
    "paged-cached-rebuild": ("paged", S,
                             "def _tables_for(self, version):\n"
                             "    tables = np.zeros((n, width))\n"
                             "    return tables\n"),
    "paged-other-tree": ("paged", REF + "models/transformer.py",
                         "def decode_step(self):\n"
                         "    ks = gather_dense(table, n)\n"),
    "paged-tests-exempt": ("paged", "tests/test_x.py",
                           "def decode_step(self):\n"
                           "    ks = gather_dense(table, n)\n"),
    "paged-cold-name": ("paged", S, "def _debug_dump(self):\n"
                                    "    ks = gather_dense(table, n)\n"),
    "net-recv": ("net", S, "class Replica:\n"
                           "    def _read(self, conn):\n"
                           "        return conn.recv(65536)\n"),
    "net-class-settimeout": ("net", S, "class Replica:\n"
                                       "    def start(self, sock):\n"
                                       "        sock.settimeout(0.2)\n"
                                       "    def _accept_loop(self, sock):\n"
                                       "        conn, addr = sock.accept()\n"
                                       "        return conn.recv(65536)\n"),
    "net-create-connection": ("net", S,
                              "import socket\n"
                              "def dial(host, port):\n"
                              "    return socket.create_connection("
                              "(host, port))\n"),
    "net-create-connection-kwarg": (
        "net", S, "import socket\ndef dial(h, p):\n"
                  "    return socket.create_connection((h, p), "
                  "timeout=1.0)\n"),
    "net-create-connection-positional": (
        "net", S, "import socket\ndef dial(h, p):\n"
                  "    return socket.create_connection((h, p), 1.0)\n"),
    "net-other-tree": ("net", REF + "models/net.py",
                       "class C:\n    def f(self, conn):\n"
                       "        return conn.recv(1)\n"),
    "net-launch": ("net", L, "class C:\n    def f(self, conn):\n"
                             "        return conn.recv(1)\n"),
    "durability-open-wb": ("durability", T,
                           "def save(p, data):\n"
                           '    with open(p, "wb") as fh:\n'
                           "        fh.write(data)\n"),
    "durability-rename-and-path-writes": ("durability", T,
                                          "import os\n"
                                          "def publish(tmp, dst):\n"
                                          "    dst.write_bytes(b'x')\n"
                                          "    os.replace(tmp, dst)\n"),
    "durability-shim-routed": ("durability", T,
                               "from . import storage\n"
                               "def save(tmp, dst, data):\n"
                               '    storage.write_bytes(tmp, data, '
                               'role="data")\n'
                               '    storage.replace(tmp, dst, '
                               'role="data")\n'),
    "durability-reads": ("durability", T,
                         "def load(p, mode):\n"
                         '    with open(p) as a, open(p, "rb") as b:\n'
                         "        pass\n"
                         "    return open(p, mode)\n"),
    "durability-results-file": ("durability", L,
                                'def report(d):\n'
                                '    (d / "results.json").write_text("{}")\n'),
    "durability-checkpoint-pointer": ("durability", L,
                                      'def meddle(d):\n'
                                      '    (d / "checkpoint.json")'
                                      '.write_text("{}")\n'),
    "durability-quant": ("durability", REF + "quant/snippet.py",
                         'def f(p):\n    open(p, "w").write("x")\n'),
    "durability-shim": ("durability", REF + "train/storage.py",
                        'def f(p):\n    open(p, "w").write("x")\n'),
    "durability-tests-exempt": ("durability", "tests/test_x.py",
                                'def f(p):\n    open(p, "w").write("x")\n'),
    "threads-racy": ("threads", S, _RACY),
    "threads-locked": ("threads", S, _LOCKED),
    "threads-init-only": ("threads", S, _INIT_ONLY),
    "threads-timer-positional": ("threads", S, _spawned(
        "threading.Timer(0.5, self._work).start()")),
    "threads-timer-function": ("threads", S, _spawned(
        "threading.Timer(0.5, function=self._work).start()")),
    "threads-thread-positional": ("threads", S, _spawned(
        "threading.Thread(None, self._work).start()")),
    "threads-loop-tuple": ("threads", S, _LOOPER),
    "threads-tests-exempt": ("threads", "tests/test_x.py", _RACY),
}


def _mirror(path: str) -> str:
    return MINE + path[len(REF):] if path.startswith(REF) else path


def _as_port(f) -> tuple:
    """A reference finding in the port's terms (package prefix mapped)."""
    key = f.key.replace(f":{REF}", f":{MINE}", 1)
    return (f.checker, _mirror(f.path), f.line, key, f.message)


def _as_tuple(f) -> tuple:
    return (f.checker, f.path, f.line, f.key, f.message)


def _config_source(cls, root: str):
    path = f"{root}core/config.py"
    return cls(path=path, tree=ast.parse((REPO / path).read_text()),
               text=(REPO / path).read_text())


@pytest.mark.parametrize("case", sorted(CASES))
def test_shared_checkers_agree_with_the_reference(case):
    checker, path, text = CASES[case]
    ref_mod, mod = CHECKS[checker]
    ref_srcs = [RefSource(path=path, tree=ast.parse(text), text=text)]
    srcs = [Source(path=_mirror(path), tree=ast.parse(text), text=text)]
    if checker == "config":
        ref_srcs.insert(0, _config_source(RefSource, REF))
        srcs.insert(0, _config_source(Source, MINE))
    want = sorted(_as_port(f) for f in ref_mod.check(ref_srcs))
    got = sorted(_as_tuple(f) for f in mod.check(srcs))
    if checker == "config":
        # each package's config.py reads its own fields in its own
        # methods, at its own lines: compare the snippet's findings, and
        # the dead-knob verdicts (not their declaration lines) on the
        # knobs the snippets touch
        def keep(found):
            return [t if t[1] == _mirror(path) else t[:2] + (None,) + t[3:]
                    for t in found if t[1] == _mirror(path) or any(
                        t[3].endswith(f"dead.{k}")
                        for k in ("train.max_steps", "train.seed",
                                  "serve.tp_ranks"))]
        want, got = keep(want), keep(got)
    assert got == want


def test_the_shared_fixtures_fire():
    """The table is not all clean twins: each shared checker fires on
    some of its cases, as the reference's tests expect."""
    fired = set()
    for case, (checker, path, text) in CASES.items():
        srcs = [Source(path=_mirror(path), tree=ast.parse(text), text=text)]
        if checker == "config":
            srcs.insert(0, _config_source(Source, MINE))
        if any(f.path == _mirror(path) or ":dead." in f.key
               for f in CHECKS[checker][1].check(srcs)):
            fired.add(checker)
    assert fired == set(CHECKS)


def test_the_registry_is_the_ports_own():
    reg = schema_check.load_registry()
    assert Path(reg.__file__) == PORT / "obsv" / "schema.py"


# -- the torch check -----------------------------------------------------

def _torch(text: str, path: str = MINE + "parallel/snippet.py"):
    return torch_check.check([Source(path=path, tree=ast.parse(text),
                                     text=text)])


def test_item_matches_the_reference_host_sync_rule():
    text = ("from jax import jit\n"
            "f = jit(lambda x: x)\n"
            "def run_loop(xs):\n"
            "    for x in xs:\n"
            "        y = f(x)\n"
            "        print(y.item())\n")
    want = ref_jax.check([RefSource(path=REF + "parallel/snippet.py",
                                    tree=ast.parse(text), text=text)])
    got = _torch(text)
    assert [(f.line, f.key.rsplit(":", 1)[1]) for f in got] == \
        [(f.line, f.key.rsplit(":", 1)[1]) for f in want] == \
        [(6, "host-sync.run_loop.item")]
    assert got[0].checker == "torch"


@pytest.mark.parametrize("call", ["item", "cpu", "tolist"])
@pytest.mark.parametrize("loop", ["for x in xs:", "while xs:"])
def test_host_sync_in_a_hot_loop_flagged(call, loop):
    got = _torch(f"def train_step_loop(xs):\n"
                 f"    {loop}\n"
                 f"        v = loss(x).{call}()\n")
    assert [f.key for f in got] == [
        f"torch:{MINE}parallel/snippet.py:host-sync.train_step_loop.{call}"]
    assert got[0].line == 3


@pytest.mark.parametrize("text", [
    # outside any loop: one sync a call, not an iteration
    "def run(xs):\n    return loss(xs).item()\n",
    # a cold function name
    "def summarize(xs):\n    for x in xs:\n        print(x.item())\n",
    # other host fetches are not this rule
    "def run(xs):\n    for x in xs:\n        a = x.numpy()\n",
])
def test_cold_code_clean(text):
    assert _torch(text) == []


def test_nested_loops_one_finding_and_tests_exempt():
    text = ("def decode_loop(rows):\n"
            "    for r in rows:\n"
            "        for c in r:\n"
            "            n = c.tolist()\n")
    assert len(_torch(text)) == 1
    assert _torch(text, path="tests/test_x.py") == []


def test_jax_only_rules_not_carried_over():
    """Use-after-donate and the Python-scalar signature have no torch
    counterpart: the reference's snippets for them give no finding."""
    for text in ("from jax import jit\n"
                 "f = jit(lambda s: s, donate_argnums=0)\n"
                 "def g(state):\n"
                 "    out = f(state)\n"
                 "    return state\n",
                 "from jax import jit\n"
                 "f = jit(lambda i, x: x)\n"
                 "def run(x):\n"
                 "    for i in range(10):\n"
                 "        f(i, x)\n"):
        assert _torch(text) == []


# -- the gate ------------------------------------------------------------

def test_all_checkers_registered():
    run_checkers([])
    assert set(CHECKERS) == {"schema", "config", "threads", "torch",
                             "paged", "net", "durability"}


def test_default_roots_are_the_ports_own():
    roots = [Path(r) for r in default_roots(REPO)]
    assert roots[0] == PORT
    names = {r.name for r in roots[1:]}
    assert "test_torch_analysis.py" in names and "_torch_threads.py" in names
    assert all(n.startswith(("test_torch_", "_torch_")) for n in names)


def test_port_clean_modulo_baseline():
    sources = iter_sources(default_roots(REPO), repo_root=REPO)
    findings = run_checkers(sources)
    baseline = load_baseline()
    new = [f for f in findings if f.key not in baseline]
    assert new == [], "\n".join(f"{f.path}:{f.line}: {f.message}"
                                for f in new)
    assert sorted(set(baseline) - {f.key for f in findings}) == []
    assert not any(f.checker == "torch" for f in findings)


def test_baseline_entries_are_the_ports_and_justified():
    raw = json.loads((PORT / "analysis" / "baseline.json").read_text())
    for entry in raw["accepted"]:
        assert entry["key"].split(":")[1].startswith(MINE), entry["key"]
        assert entry.get("justification", "").strip(), entry["key"]


def test_cli_exits_zero_over_the_port():
    p = subprocess.run([sys.executable, "-m",
                        "distributedmnist_tpu_torch.analysis", "--format",
                        "json"], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-2000:]
    report = json.loads(p.stdout)
    assert report["ok"] is True and report["stale_baseline"] == []
    assert report["files_analyzed"] > 50
    assert "torch" in report["checkers"]


def test_cli_exits_one_on_a_new_finding(tmp_path, capsys):
    bad = tmp_path / "snippet.py"
    bad.write_text('sink.write({"event": "telemetry", "x": 1})\n')
    assert cli_main([str(bad), "--checkers", "schema"]) == 1
    assert 'undeclared journal event kind "telemetry"' in \
        capsys.readouterr().out


def test_cli_exits_two_on_a_stale_entry(tmp_path):
    entries = json.loads((PORT / "analysis" / "baseline.json").read_text())
    entries["accepted"].append(
        {"key": f"threads:{MINE}servesvc/server.py:ServingReplica.gone",
         "justification": "no longer written"})
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(entries))
    root = str(PORT / "servesvc")
    assert cli_main([root, "--checkers", "threads", "--baseline",
                     str(path)]) == 2
    # a subset run that did not analyze the file judges nothing stale
    assert cli_main([str(PORT / "train"), "--checkers", "threads",
                     "--baseline", str(path)]) == 0


def test_unknown_checker_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        cli_main(["--checkers", "cofnig"])
    assert e.value.code == 2
    assert "unknown checker" in capsys.readouterr().err


def test_unparseable_file_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def broken(:\n")
    findings = run_checkers(iter_sources([bad], repo_root=tmp_path))
    assert any(f.checker == "parse" and "syntax-error" in f.key
               for f in findings)


def test_checkers_import_nothing_they_analyze():
    """Standard library and the package's own relative imports only."""
    allowed = {"__future__", "argparse", "ast", "dataclasses",
               "importlib", "json", "pathlib", "re", "sys", "typing"}
    for f in sorted((PORT / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, f"{f.name}: {n}"
